"""Device traces of slices of a traced run, taken after its window:
torch.profiler with CUDA activity over one call, reduced to the device's busy time (the
union of its operations' intervals), its operations by name, its idle
gaps, and its kernel launches."""

from __future__ import annotations

import time

import torch


def _events(prof):
    """[(start_ns, end_ns, name)] of the operations that ran on the card."""
    from torch.autograd import DeviceType

    out = []
    raw = getattr(getattr(prof, "profiler", None), "kineto_results", None)
    if raw is not None:
        for e in raw.events():
            if e.device_type() != DeviceType.CUDA:
                continue
            if hasattr(e, "start_ns"):
                s, d = e.start_ns(), e.duration_ns()
            else:
                s, d = 1000 * e.start_us(), 1000 * e.duration_us()
            out.append((s, s + d, e.name()))
        return out
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            out.append((1000 * e.time_range.start, 1000 * e.time_range.end, e.name))
    return out


def is_kernel(name: str) -> bool:
    return not (name.startswith("Memcpy") or name.startswith("Memset"))


def trace_call(fn):
    """Run fn() under the profiler. -> (fn's result, summary dict with
    window_s (host clock, synchronised at both ends), busy_s, launches,
    device_ops [(name, s)], idle_gaps [(label, s)])."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        result = fn()
        torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
    ev = sorted(_events(prof))
    busy_ns, by_name, gaps = 0, {}, []
    cur_s = cur_e = None
    for s, e, name in ev:
        by_name[name] = by_name.get(name, 0) + (e - s)
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy_ns += cur_e - cur_s
                gaps.append((s - cur_e, name))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy_ns += cur_e - cur_s
    gaps.sort(reverse=True)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return result, {
        "window_s": window_s,
        "busy_s": busy_ns * 1e-9,
        "launches": sum(1 for _, _, n in ev if is_kernel(n)),
        "device_ops": [[n[:120], t * 1e-9] for n, t in top],
        "idle_gaps": [[f"host dispatch before {n[:100]}", g * 1e-9] for g, n in gaps[:10]],
    }
