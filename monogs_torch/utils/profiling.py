"""Wall-clock section timers and device traces (port of
monogs_tpu/utils/profiling.py).

`section(name, sync=True)` times a block on the host clock; with sync it
first waits for the work queued on the calling thread's current CUDA
stream, so the time covers what the block dispatched (and, with two
threads on two streams, not the other thread's work). `summary()` feeds
the run's metrics.json "stages"; `device_trace` records a torch.profiler
trace of the CPU and, where there is one, the card.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict

import torch

_sections: dict[str, list[float]] = defaultdict(list)


@contextlib.contextmanager
def section(name: str, sync: bool = False, device=None):
    """Wall-clock section timer. sync=True waits for the calling thread's
    current stream on `device` before reading the clock when it is a CUDA
    device (device None: the current CUDA device, where there is one), so
    the time covers the work the block dispatched and not only its
    dispatch."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        if sync and (torch.device(device).type == "cuda" if device is not None
                     else torch.cuda.is_available()):
            torch.cuda.current_stream(device).synchronize()
        _sections[name].append(time.perf_counter() - t0)


def summary() -> dict:
    return {
        name: {
            "n": len(v),
            "total_s": sum(v),
            "mean_ms": 1e3 * sum(v) / max(len(v), 1),
        }
        for name, v in _sections.items()
    }


def reset():
    _sections.clear()


@contextlib.contextmanager
def device_trace(logdir: str):
    """Record a torch.profiler trace of the block (CPU, and the card when
    there is one) as a Chrome trace under `logdir`."""
    import os

    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield prof
    os.makedirs(logdir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(logdir, f"trace-{os.getpid()}.json"))
