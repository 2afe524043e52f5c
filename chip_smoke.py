#!/usr/bin/env python3
"""Smoke run of the PyTorch port (monogs_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line each; any failure propagates and exits non-zero:
  1. device: name, count, `nvidia-smi` name and power limit;
  2. build: nvcc of monogs_torch/csrc/composite.cu and microbench.cu
     (sm_90a, one nvcc each, started together) and their -Xptxas -v
     reports;
  3. kernels against their plain PyTorch twins on the card, at the
     bench.py widths (640x480, 100k Gaussians, tile 32, K 2048,
     entry_capacity 210432) and at n_img=2 on a small slab;
  4. the tracking path: 3 frames rendered at known poses through `render`,
     each tracked with `track_frame` from a perturbed start; the pose error
     must shrink and every kernel must have launched on that path;
  5. tracking timing: ms per tracking iteration (100 forced iterations,
     median of 5), a torch.profiler breakdown of 16 iterations (device busy
     time, idle share, launches and the top kernels per iteration; the
     profiler's own host cost inflates the idle share), and each kernel's
     time at the tracking shapes;
  6. kernels at the mapping widths (scripts/bench_mapping.py: 640x480,
     fx 520.9 / fy 521.0, window 8, map capacity 131,072 with 80,000 live,
     tile 32, K 1024, entry_capacity 210432, its map distributions with
     opacity logits N(0, 1); the 8 keyframes are rendered from a
     numpy-seeded map at bench_mapping's poses, where bench_mapping uses
     random images): both slab kernels at n_img 8 against their twins, the
     batched relayout at (8, 131072, 16), and the roofline probe kernel for
     each op against its twin;
  7. the mapping path, from a map like phase 6's but with opacity logits
     N(2.5, 1) (PATH_OPACITY_SHIFT: the densify event prunes opacity below
     0.7, 80% of an N(0, 1) map): a MapperState starts from a perturbed
     copy of the map; `extend_event` on keyframe 0,
     `run_optimize_map(iters=100)` from iteration 0 (the densify event at
     50 fires), `visibility_pass` and `covisibility_prune`. The window loss
     must fall, everything stay finite, the active count change, and every
     kernel launch on the path;
  8. mapping timing on phase 6's state: the host syncs of one 8-iteration
     span, ms per mapping iteration (median of 5 spans of 8), a profiler
     breakdown of one span, the live pairs under both opacity
     distributions, each kernel's time at the mapping shapes beside its
     twin, the library call and its bound, the probe's ns per step for fma
     / exp / log1p / div (the roofline probe's main path) and the slab
     kernels' measured-rate floors at both widths;
then the kernels' JSON line (each row's `launches` is the sum of the
per-path counts beside it; its times, bound and error are at the mapping
shapes, or the probe's) and, last, {"ok": true, "device": {...}}.

Tolerances (kernel vs plain twin on the same inputs): forward rgb / alpha
1e-5 and depth 1e-4 absolute (the JAX suite's Pallas-vs-oracle bounds);
touched and the relayout bit-exact; backward per feature channel
max|kernel - plain| <= 1e-4 * max|plain| (only the order of the per-slot
sums over the tile's pixels differs); the probe max|kernel - plain| <=
1e-5 * max|plain| at n_rep 16 (a chain of expf / log1pf may round apart
from torch.exp / torch.log1p by an ulp a step; the chains do not amplify
it).
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time
import warnings

H100_FP32_OPS = 67e12    # float32 outside the tensor cores, op/s
H100_HBM_BYTES = 3.35e12  # B/s
# float32 operations per live (pixel, slot) pair, counted from
# csrc/composite.cu with each expf / log1pf as one operation:
#   forward:  dx, dy 2; power 9; clamp + expf 2; alpha_raw, tests, min 4;
#             Tk 2; w 1; acc 9; log1pf + running sum 2       = 31
#   backward: the forward's alpha, Tk, w and log T terms 20; g 8;
#             wg, prefixes, S 4; dalpha 4; mask, dpower 3; 10 per-slot
#             gradients 22; their 10-value warp sums ~2      = 63
FWD_OPS_PER_PAIR = 31
BWD_OPS_PER_PAIR = 63

W, H, N = 640, 480, 100_000
SEED = 0
# The mapping workload: scripts/bench_mapping.py's widths.
MW, MH, M_CAP, M_LIVE, WIN, M_ECAP = 640, 480, 131_072, 80_000, 8, 210_432
M_ITERS = 100
# The event path's ground-truth opacity logits are N(PATH_OPACITY_SHIFT, 1):
# the densify event prunes every Gaussian below gaussian_th = 0.7 (logit
# 0.847), which is 80% of an N(0, 1) map and 5% of this one.
PATH_OPACITY_SHIFT = 2.5
PROBE_CHECK_REP = 16


def require(cond: bool, what: str):
    if not cond:
        raise RuntimeError(what)


def line(tag: str, **kv):
    print(f"[{tag}] " + " ".join(f"{k}={v}" for k, v in kv.items()), flush=True)


def fwd_err(a, b) -> tuple[float, bool]:
    """Max abs error of a forward output and whether it meets the stated
    tolerances (rgb / alpha 1e-5, depth 1e-4)."""
    d = (a - b).abs().amax(dim=(0, 1))
    ok = bool(d[[0, 1, 2, 4]].max() <= 1e-5) and bool(d[3] <= 1e-4)
    return float(d.max()), ok


def bwd_err(a, b) -> tuple[float, bool]:
    """Max abs error of dfeats and whether every channel meets
    max|a - b| <= 1e-4 max|b|."""
    d = (a - b).abs().amax(dim=(0, 2))
    scale = b.abs().amax(dim=(0, 2))
    return float(d.max()), bool((d <= 1e-4 * scale).all())


def cuda_ms(fn, reps: int, warmup: int = 2, graph: bool = False) -> float:
    """Mean device time of fn() over `reps` back-to-back calls (CUDA events).
    graph=True captures the `reps` calls in one CUDA graph and times its
    replay, so a kernel shorter than its host-side launch is timed on the
    device and not at the host's launch rate; fn must not sync the host."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    run = fn
    if graph:
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            for _ in range(reps):
                fn()
        g.replay()
        run = g.replay
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(1 if graph else reps):
        run()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_profile(fn, iters: int, top: int = 8) -> dict:
    """Run fn() (`iters` tracking iterations) under torch.profiler and
    break its device work down: busy time (the union of kernel, memcpy and
    memset intervals), the launches, and the `top` names by device time,
    all per iteration, beside the host-clock wall time of the profiled run;
    None when the profiler saw no device activity."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    evs = sorted((e for e in prof.events() if e.device_type == DeviceType.CUDA),
                 key=lambda e: e.time_range.start)
    busy_us, end, by_name = 0.0, -math.inf, {}
    for e in evs:
        s, f = e.time_range.start, e.time_range.end
        busy_us += max(0.0, f - max(s, end))
        end = max(end, f)
        tot, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (tot + f - s, n + 1)
    if not evs:
        return None
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]
    return {
        "wall_ms_per_iter": wall_ms / iters,
        "device_busy_ms_per_iter": busy_us / 1e3 / iters,
        "device_launches_per_iter": len(evs) / iters,
        "top": [(name[:72], round(tot / 1e3 / iters, 4), round(n / iters, 2))
                for name, (tot, n) in ranked],
    }


def time_kernel(kfn, pfn, lfn, ops: float, nbytes: float, plain_reps: int = 2) -> dict:
    """A kernel's device time (CUDA-graph replay of 20 launches) beside its
    plain twin's, the library call's where there is one, and its bound:
    the larger of ops at the float32 peak and bytes at the HBM rate."""
    bound_ops, bound_bytes = ops / H100_FP32_OPS * 1e3, nbytes / H100_HBM_BYTES * 1e3
    return {"ms": cuda_ms(kfn, 20, graph=True),
            "plain_ms": cuda_ms(pfn, plain_reps, warmup=1),
            "library_ms": cuda_ms(lfn, 20, graph=True) if lfn else None,
            "bound_ms": max(bound_ops, bound_bytes),
            "bound_by": "operations" if bound_ops >= bound_bytes else "bytes"}


def build_mapping_state(dev, opacity_shift: float = 0.0):
    """The mapping path's inputs: a ground-truth map of M_LIVE Gaussians
    drawn with numpy from SEED with scripts/bench_mapping.py's distributions
    (opacity logits N(0, 1), plus `opacity_shift`), WIN keyframes rendered
    from it at
    bench_mapping's poses and intrinsics (bench_mapping's frames are random
    images instead), and a MapperState of capacity M_CAP whose first M_LIVE
    rows are a perturbed copy of that map (rgb noise 0.15, opacity-logit
    noise 0.3). -> (state, intr, cfg)."""
    import numpy as np
    import torch
    from monogs_torch.models.optim import init_adam
    from monogs_torch.ops.graphics import Intrinsics
    from monogs_torch.ops.render import render
    from monogs_torch.slam.camera import make_frame, window_from_list
    from monogs_torch.slam.mapper import MapperConfig, init_mapper_state
    from monogs_torch.tools.roofline import bench_map

    intr = Intrinsics(fx=520.9, fy=521.0, cx=MW / 2, cy=MH / 2, width=MW, height=MH)
    cfg = MapperConfig(entry_capacity=M_ECAP)
    gt = bench_map(M_LIVE, SEED + 2, dev)
    gt["opacity_logit"] = gt["opacity_logit"] + opacity_shift
    frames = []
    with torch.no_grad():
        for i in range(WIN):
            pose = torch.eye(4, device=dev)
            pose[:3, 3] = torch.tensor([0.02 * i, -0.01 * i, 0.03 * i], device=dev)
            out = render(gt["xyz"], torch.exp(gt["log_scales"]), gt["quats"],
                         torch.sigmoid(gt["opacity_logit"]), gt["rgb"], pose[:3, :3],
                         pose[:3, 3], intr, tile_size=cfg.tile_size,
                         tile_capacity=cfg.tile_capacity, max_dup=cfg.max_dup,
                         max_dup_gen=cfg.max_dup_gen, entry_capacity=M_ECAP,
                         with_n_touched=False)
            frames.append(make_frame(i, out.rgb, out.depth, pose, device=dev))
    state = init_mapper_state(M_CAP, 1, window_from_list(frames, WIN), seed=SEED)
    rng = np.random.default_rng(SEED + 3)
    noisy = dict(gt)
    noisy["rgb"] = torch.clamp(gt["rgb"] + torch.as_tensor(
        rng.normal(0.0, 0.15, (M_LIVE, 3)), dtype=torch.float32, device=dev), 0.0, 1.0)
    noisy["opacity_logit"] = gt["opacity_logit"] + torch.as_tensor(
        rng.normal(0.0, 0.3, M_LIVE), dtype=torch.float32, device=dev)
    params = {k: v.clone() for k, v in state.gmap.params.items()}
    for k in params:
        params[k][:M_LIVE] = noisy[k]
    active = torch.arange(M_CAP, device=dev) < M_LIVE
    gmap = state.gmap._replace(params=params, active=active)
    return state._replace(gmap=gmap, adam=init_adam(params)), intr, cfg


def window_slab(state, intr, cfg):
    """The window's bins and its (WIN, 16, E_cap) slab, with the global
    block starts and counts of all WIN * tiles tiles, as a mapping
    iteration's forward builds them. -> (bins, feats, pstart, counts)."""
    import torch
    from monogs_torch.ops import tile_raster
    from monogs_torch.ops.binning import SLAB
    from monogs_torch.ops.render import project_window
    from monogs_torch.slam import mapper as tm

    with torch.no_grad():
        bins = tm.window_bins(state, intr, cfg)
        g, f = state.gmap, state.window.frames
        z = torch.zeros_like(f.t)
        p = project_window(g.params["xyz"], torch.exp(g.params["log_scales"]),
                           g.params["quats"], torch.sigmoid(g.params["opacity_logit"]),
                           f.R, f.t, z, z, intr, active=g.active)
        opa = torch.where(p.valid, p.opacity, torch.zeros_like(p.opacity))
        rgb = g.params["rgb"]
        feats = tile_raster.pack_features_window(
            p.u, p.v, p.ca, p.cb, p.cc, opa, p.depth, rgb[:, 0], rgb[:, 1], rgb[:, 2],
            bins.gauss_of_pos, bins.gsort_pos, bins.gseg_start, bins.g_last, cfg.max_dup)
    img = torch.arange(WIN, dtype=torch.int32, device=feats.device)[:, None]
    pstart = (bins.pstart_blk + img * (feats.shape[2] // SLAB)).reshape(-1).contiguous()
    return bins, feats, pstart, bins.counts.reshape(-1).contiguous()


def window_pairs(feats, pstart, counts, rcfg) -> int:
    """Live (pixel, slot) pairs of a window slab (roofline.slab_pairs per
    keyframe)."""
    from monogs_torch.tools import roofline

    T = rcfg.num_tiles
    return sum(roofline.slab_pairs(feats, pstart[w * T:(w + 1) * T],
                                   counts[w * T:(w + 1) * T], rcfg)["live"]
               for w in range(WIN))


def mapping_phases(dev, smi: str, track_launches: dict, track_slab) -> list:
    """Phases 6-8 (see the module docstring); -> the kernels' JSON rows."""
    import torch
    from monogs_torch.ops import kernels, tile_raster
    from monogs_torch.ops.render import make_raster_config
    from monogs_torch.slam import mapper as tm
    from monogs_torch.slam.camera import window_get
    from monogs_torch.tools import roofline

    # The timed workload (phases 6 and 8) has bench_mapping's distributions;
    # the event path (phase 7) starts from the opacity-shifted map.
    t0 = time.perf_counter()
    state_t, intr, cfg = build_mapping_state(dev)
    state0, _, _ = build_mapping_state(dev, PATH_OPACITY_SHIFT)
    rcfg = make_raster_config(MW, MH, cfg.tile_size)
    K = cfg.tile_capacity
    line("mapping", built_s=f"{time.perf_counter() - t0:.1f}", capacity=M_CAP,
         live=M_LIVE, window=WIN, tiles_per_image=rcfg.num_tiles)

    # 6. Kernels at the mapping widths against their twins.
    bins, feats, pstart, counts = window_slab(state_t, intr, cfg)
    args = (feats, pstart, counts, rcfg)
    T = rcfg.num_tiles

    def fwd_plain(touched):
        outs = [tile_raster._fwd_slab_plain(feats, pstart[w * T:(w + 1) * T],
                                            counts[w * T:(w + 1) * T], rcfg, K, touched)
                for w in range(WIN)]
        return torch.cat([o for o, _ in outs]), torch.cat([t for _, t in outs])

    def bwd_plain(baux):
        return sum(tile_raster._bwd_slab_plain(feats, pstart[w * T:(w + 1) * T],
                                               counts[w * T:(w + 1) * T],
                                               baux[w * T:(w + 1) * T], rcfg)
                   for w in range(WIN))

    out_k, _ = kernels.slab_fwd(*args, K, False)
    out_kt, touched_k = kernels.slab_fwd(*args, K, True)
    out_p, touched_p = fwd_plain(True)
    torch.cuda.synchronize()
    err_fwd, ok1 = fwd_err(out_k, out_p)
    err_fwdt, ok2 = fwd_err(out_kt, out_p)
    touched_exact = bool(torch.equal(touched_k, touched_p))
    line("check", kernel="slab_fwd", shape="mapping", n_img=WIN, tiles=pstart.numel(),
         max_abs_err=err_fwd, max_abs_err_touched_variant=err_fwdt,
         touched_bit_exact=touched_exact, entries=int(counts.sum()),
         overflow=int(bins.overflow.sum()))
    require(ok1 and ok2 and touched_exact, "slab_fwd disagrees with its twin at n_img 8")
    g_out = torch.randn(out_p.shape, generator=torch.Generator(dev).manual_seed(5),
                        device=dev)
    baux = tile_raster.bwd_aux(out_p, g_out)
    d_k = kernels.slab_bwd(*args[:3], baux, rcfg)
    d_p = bwd_plain(baux)
    torch.cuda.synchronize()
    err_bwd, ok = bwd_err(d_k, d_p)
    line("check", kernel="slab_bwd", shape="mapping", n_img=WIN, max_abs_err=err_bwd,
         max_abs_plain=float(d_p.abs().max()))
    require(ok, "slab_bwd disagrees with its twin at n_img 8")
    xw = torch.randn((WIN, M_CAP, 16), generator=torch.Generator(dev).manual_seed(6),
                     device=dev)
    relayout_exact = bool(torch.equal(kernels.rows_to_channels(xw),
                                      tile_raster._rows_to_channels_plain(xw)))
    line("check", kernel="rows_to_channels", shape=tuple(xw.shape),
         bit_exact=relayout_exact)
    require(relayout_exact, "batched rows_to_channels disagrees with its twin")
    xp = roofline.probe_input(device=dev)
    probe_err = {}
    for op in roofline.OPS:
        k = kernels.op_microbench(xp, op, PROBE_CHECK_REP, roofline.PROBE_LANES)
        pl_ = roofline.op_chain_plain(xp, op, PROBE_CHECK_REP, roofline.PROBE_LANES)
        torch.cuda.synchronize()
        probe_err[op] = float((k - pl_).abs().max())
        line("check", kernel="op_microbench", op=op, shape=tuple(xp.shape),
             n_rep=PROBE_CHECK_REP, max_abs_err=probe_err[op],
             bit_exact=bool(torch.equal(k, pl_)))
        require(probe_err[op] <= 1e-5 * float(pl_.abs().max()),
                f"op_microbench({op}) disagrees with its twin")

    # 7. The mapping path.
    _, aux0 = tm.mapping_step(state0, intr, cfg)
    loss0 = float(aux0.loss)
    n0 = int(state0.gmap.num_active)
    path = (kernels.slab_fwd, kernels.slab_bwd, kernels.rows_to_channels)
    for k in path:
        k.launches = 0
    t0 = time.perf_counter()
    state, (n_added, n_dropped) = tm.extend_event(
        state0, window_get(state0.window, 0), WIN, intr, cfg, init=False)
    n1 = int(state.gmap.num_active)
    state, _ = tm.run_optimize_map(state, intr, cfg, M_ITERS)
    n2 = int(state.gmap.num_active)
    vis = tm.visibility_pass(state, intr, cfg)
    state, pruned = tm.covisibility_prune(state, vis, WIN - 2, cfg)
    torch.cuda.synchronize()
    path_s = time.perf_counter() - t0
    map_launches = {k.__name__: k.launches for k in path}
    n3 = int(state.gmap.num_active)
    _, aux1 = tm.mapping_step(state, intr, cfg)
    loss1 = float(aux1.loss)
    finite = all(bool(torch.isfinite(v).all()) for v in state.gmap.params.values()) and \
        bool(torch.isfinite(state.window.frames.R).all())
    line("mapping", iters=M_ITERS, s=f"{path_s:.2f}", loss=f"{loss0:.6f}->{loss1:.6f}",
         active=f"{n0}->{n1}(extend,+{int(n_added)},dropped {int(n_dropped)})->{n2}"
                f"(densify@50)->{n3}(coviz prune {int(pruned.sum())})",
         finite=finite, nr_iters=int(state.nr_iters))
    line("launches", path="mapping", iterations=M_ITERS, **map_launches)
    require(finite and math.isfinite(loss1), "non-finite mapping output")
    require(loss1 < loss0, "the window loss did not fall")
    require(n2 != n1, "the active count did not change at densify")
    require(map_launches["slab_fwd"] >= M_ITERS + 2
            and map_launches["slab_bwd"] >= M_ITERS
            and map_launches["rows_to_channels"] >= M_ITERS,
            "a kernel of the mapping path did not launch on it")

    # 8. Mapping timing, on phase 6's state: first the host syncs of one
    # span (the "synchronizing CUDA operation" warnings only; the debug
    # mode's own one-time notice is not a sync).
    span_cfg = dataclasses.replace(cfg, converged_eps=0.0)
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            st, _ = tm.mapping_span(state_t, intr, span_cfg, False, 0, cfg.rebin_every)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    where = {}
    for w in caught:
        if "called a synchronizing CUDA operation" in str(w.message):
            at = f"{os.path.relpath(w.filename)}:{w.lineno}"
            where[at] = where.get(at, 0) + 1
    line("syncs", span_iters=cfg.rebin_every, host_syncs=sum(where.values()),
         at=repr(where))
    reps = []
    for k in path:
        k.launches = 0
    for _ in range(5):
        t0 = time.perf_counter()
        st, aux = tm.mapping_span(st, intr, span_cfg, False, 0, cfg.rebin_every)
        torch.cuda.synchronize()
        reps.append((time.perf_counter() - t0) / cfg.rebin_every * 1e3)
    per_iter = {k.__name__: k.launches / (5 * cfg.rebin_every) for k in path}
    line("timing", mapping_ms_per_iter=statistics.median(reps), min=min(reps),
         max=max(reps), spans=5, iters_per_span=cfg.rebin_every, card=repr(smi))
    prof = device_profile(lambda: tm.mapping_span(st, intr, span_cfg, False, 0,
                                                  cfg.rebin_every), cfg.rebin_every)
    if prof is None:
        line("profile", path="mapping", device_busy="not measured (the profiler saw "
             "no device activity)")
    else:
        line("profile", path="mapping", iters=cfg.rebin_every,
             **{k: v for k, v in prof.items() if k != "top"},
             idle_share=1.0 - prof["device_busy_ms_per_iter"] / prof["wall_ms_per_iter"],
             card=repr(smi))
        for op, op_ms, calls in prof["top"]:
            print(f"  device: {op_ms:.4f} ms/iter  {calls:7.2f} calls/iter  {op}")

    pairs = window_pairs(feats, pstart, counts, rcfg)
    pairs_path = window_pairs(*window_slab(state0, intr, cfg)[1:], rcfg)
    line("pairs", shape="mapping", live_pairs_timed=pairs, opacity_logits_timed="N(0,1)",
         live_pairs_event_path=pairs_path,
         opacity_logits_event_path=f"N({PATH_OPACITY_SHIFT},1)")
    feat_bytes = 10 * 4 * pairs // rcfg.pixels
    rows = {
        "slab_fwd": ("cuda", "monogs_torch/csrc/composite.cu",
                     "monogs_tpu/ops/tile_raster.py:284 (_slab_fwd_kernel, via _fwd_slab :467)",
                     lambda: kernels.slab_fwd(*args, K, False), lambda: fwd_plain(False),
                     None, FWD_OPS_PER_PAIR * pairs, feat_bytes + out_p.numel() * 4,
                     err_fwd),
        "slab_bwd": ("cuda", "monogs_torch/csrc/composite.cu",
                     "monogs_tpu/ops/tile_raster.py:355 (_slab_bwd_kernel, via _bwd_slab :517)",
                     lambda: kernels.slab_bwd(*args[:3], baux, rcfg), lambda: bwd_plain(baux),
                     None, BWD_OPS_PER_PAIR * pairs, 2 * feat_bytes + baux.numel() * 4,
                     err_bwd),
        "rows_to_channels": ("triton", "monogs_torch/csrc/relayout.py",
                             "monogs_tpu/ops/tile_raster.py:622 (rows_to_channels / "
                             "_relayout_kernel :618, vmapped in _pfw_bwd :792)",
                             lambda: kernels.rows_to_channels(xw),
                             lambda: tile_raster._rows_to_channels_plain(xw),
                             lambda: xw.transpose(1, 2).contiguous(), 0,
                             2 * xw.numel() * 4, 0.0),
    }
    report = []
    for kname, (route, source, replaces, kfn, pfn, lfn, ops, nbytes, err) in rows.items():
        t = time_kernel(kfn, pfn, lfn, ops, nbytes)
        report.append({"name": kname, "route": route, "source": source,
                       "replaces": replaces,
                       "launches": track_launches[kname] + map_launches[kname],
                       "launches_tracking": track_launches[kname],
                       "launches_mapping": map_launches[kname],
                       "shape": "mapping", "max_abs_err": err, **t})
        line("kernel", shape="mapping", name=kname, **t,
             launches_per_mapping_iter=per_iter[kname], card=repr(smi))
    line("kernel", shape="mapping", name="slab_fwd(touched)",
         ms=cuda_ms(lambda: kernels.slab_fwd(*args, K, True), 20, graph=True),
         live_pairs=pairs)

    # The roofline probe's main path: the four rates at the probe shape.
    kernels.op_microbench.launches = 0
    rates = {op: roofline.op_microbench(op) for op in roofline.OPS}
    probe_launches = kernels.op_microbench.launches
    line("roofline", **{f"{op}_ns_per_step": v for op, v in rates.items()},
         shape=roofline.PROBE_SHAPE, n_rep=roofline.PROBE_REP,
         lanes=roofline.PROBE_LANES, launches=probe_launches, card=repr(smi))
    require(probe_launches == 4 * len(roofline.OPS), "the probe kernel did not launch")
    tf, tb, tr = track_slab
    t_pairs = roofline.slab_pairs(tf, tb.pstart_blk, tb.counts, tr)["live"]
    for shape, n in (("tracking", t_pairs), ("mapping", pairs)):
        line("floor", shape=shape, live_pairs=n, **roofline.floors_ms(n, rates),
             card=repr(smi))
    steps = xp.numel() * roofline.PROBE_REP * roofline.PROBE_LANES
    t = time_kernel(lambda: kernels.op_microbench(xp, "exp", roofline.PROBE_REP,
                                                  roofline.PROBE_LANES),
                    lambda: roofline.op_chain_plain(xp, "exp", roofline.PROBE_REP,
                                                    roofline.PROBE_LANES),
                    None, 3 * steps, (xp.numel() + xp[0].numel()) * 4, plain_reps=1)
    line("kernel", name="op_microbench(exp)", **t, card=repr(smi))
    report.append({"name": "op_microbench", "route": "cuda",
                   "source": "monogs_torch/csrc/microbench.cu",
                   "replaces": "scripts/bench_roofline.py:44 (op_microbench, "
                               "pl.pallas_call :86)",
                   "launches": probe_launches, "launches_roofline": probe_launches,
                   "shape": "probe", "max_abs_err": max(probe_err.values()), **t})
    return report


def pose_error(R, t, R_gt, t_gt) -> tuple[float, float]:
    """(rotation error in rad, camera-centre error) between two w2c poses."""
    import torch
    from monogs_torch.ops import lie

    rot = float(torch.linalg.vector_norm(lie.so3_log(R @ R_gt.T)))
    c = -R.T @ t
    c_gt = -R_gt.T @ t_gt
    return rot, float(torch.linalg.vector_norm(c - c_gt))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU only",
              file=sys.stderr)
        return 2
    from monogs_torch.ops import kernels, lie, tile_raster
    from monogs_torch.ops.graphics import Intrinsics
    from monogs_torch.tools import roofline
    from monogs_torch.ops.render import make_raster_config, render
    from monogs_torch.slam.camera import make_frame
    from monogs_torch.slam.tracker import TrackerConfig, track_frame

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    # 1. Device.
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    line("device", name=repr(torch.cuda.get_device_name(0)),
         count=torch.cuda.device_count(), smi=repr(smi),
         torch=torch.__version__, cuda=torch.version.cuda)

    # 2. Build (nvcc from the checkout, one process per source, all at once;
    # Triton compiles at its first launch).
    t0 = time.perf_counter()
    kernels.build_all()
    line("build", sources="+".join(kernels.CUDA_SOURCES),
         nvcc_s=f"{time.perf_counter() - t0:.1f}")
    for ln in kernels.build_log("composite").splitlines():
        if "registers" in ln or "spill" in ln or "Compiling entry" in ln:
            print("  ptxas:", ln.strip().removeprefix("ptxas info    : "))
    mb = kernels.build_log("microbench")
    regs = [int(r) for r in re.findall(r"Used (\d+) registers", mb)]
    line("build", microbench_variants=len(regs), registers=f"{min(regs)}-{max(regs)}",
         spill_bytes=sum(int(x) for x in re.findall(r"(\d+) bytes spill stores", mb)))

    # 3. Kernels against their plain twins, at bench widths.
    intr = Intrinsics(fx=520.9, fy=521.0, cx=W / 2, cy=H / 2, width=W, height=H)
    cfg = TrackerConfig(opacity_threshold=0.5, entry_capacity=210432)
    rcfg = make_raster_config(W, H, cfg.tile_size)
    K = cfg.tile_capacity
    params = roofline.bench_map(N, SEED, dev)
    eye, z3 = torch.eye(3, device=dev), torch.zeros(3, device=dev)
    feats, bins, slab_cfg = roofline.tracking_slab(dev, SEED)
    require(slab_cfg == rcfg and K == 2048, "tracking_slab is not the tracker's workload")
    args = (feats, bins.pstart_blk, bins.counts, rcfg)
    out_k, _ = kernels.slab_fwd(*args, K, False)
    out_kt, touched_k = kernels.slab_fwd(*args, K, True)
    out_p, touched_p = tile_raster._fwd_slab_plain(*args, K, True)
    torch.cuda.synchronize()
    err_fwd, ok1 = fwd_err(out_k, out_p)
    err_fwdt, ok2 = fwd_err(out_kt, out_p)
    touched_exact = bool(torch.equal(touched_k, touched_p))
    line("check", kernel="slab_fwd", max_abs_err=err_fwd,
         max_abs_err_touched_variant=err_fwdt, touched_bit_exact=touched_exact,
         entries=int(bins.counts.sum()), overflow=int(bins.overflow))
    require(ok1 and ok2 and touched_exact, "slab_fwd disagrees with its plain twin")

    g_out = torch.randn(out_p.shape, generator=torch.Generator(dev).manual_seed(1),
                        device=dev)
    baux = tile_raster.bwd_aux(out_p, g_out)
    d_k = kernels.slab_bwd(*args[:3], baux, rcfg)
    d_p = tile_raster._bwd_slab_plain(*args[:3], baux, rcfg)
    torch.cuda.synchronize()
    err_bwd, ok = bwd_err(d_k, d_p)
    line("check", kernel="slab_bwd", max_abs_err=err_bwd,
         max_abs_plain=float(d_p.abs().max()))
    require(ok, "slab_bwd disagrees with its plain twin")

    x = torch.randn((N, 16), generator=torch.Generator(dev).manual_seed(2),
                    device=dev)
    t0 = time.perf_counter()
    y_k = kernels.rows_to_channels(x)
    torch.cuda.synchronize()
    triton_s = time.perf_counter() - t0
    relayout_exact = bool(torch.equal(y_k, tile_raster._rows_to_channels_plain(x)))
    line("check", kernel="rows_to_channels", n=N, bit_exact=relayout_exact,
         first_call_s=f"{triton_s:.1f}")
    require(relayout_exact, "rows_to_channels disagrees with its plain twin")

    # n_img=2: two views' slabs in one launch, global tile ids.
    sw, sh = 128, 96
    s_intr = Intrinsics(fx=110.0, fy=110.0, cx=sw / 2, cy=sh / 2, width=sw, height=sh)
    s_cfg = TrackerConfig(tile_size=16, tile_capacity=512, entry_capacity=None)
    s_rcfg = make_raster_config(sw, sh, 16)
    s_params = roofline.bench_map(3000, SEED + 1, dev)
    views = [roofline.slab_inputs(s_params, s_intr, *lie.apply_pose_delta(
        eye, z3, torch.tensor([0.02 * i, 0.0, 0.0], device=dev),
        torch.tensor([0.0, 0.01 * i, 0.0], device=dev)), s_cfg.tile_size,
        s_cfg.tile_capacity, s_cfg.entry_capacity) for i in range(2)]
    E_cap = views[0][1].shape[2]
    feats2 = torch.cat([v[1] for v in views]).contiguous()
    pstart2 = torch.cat([views[0][0].pstart_blk,
                         views[1][0].pstart_blk + E_cap // 512])
    counts2 = torch.cat([v[0].counts for v in views])
    args2 = (feats2, pstart2, counts2, s_rcfg)
    o2k, t2k = kernels.slab_fwd(*args2, 512, True)
    o2p, t2p = tile_raster._fwd_slab_plain(*args2, 512, True)
    g2 = torch.randn(o2p.shape, generator=torch.Generator(dev).manual_seed(3),
                     device=dev)
    b2 = tile_raster.bwd_aux(o2p, g2)
    d2k = kernels.slab_bwd(*args2[:3], b2, s_rcfg)
    d2p = tile_raster._bwd_slab_plain(*args2[:3], b2, s_rcfg)
    torch.cuda.synchronize()
    e2f, ok2f = fwd_err(o2k, o2p)
    e2b, ok2b = bwd_err(d2k, d2p)
    t2_exact = bool(torch.equal(t2k, t2p))
    line("check", kernel="slab_fwd+slab_bwd", n_img=2, fwd_err=e2f, bwd_err=e2b,
         touched_bit_exact=t2_exact, entries=int(counts2.sum()))
    require(ok2f and ok2b and t2_exact, "n_img=2 slab disagrees with its plain twin")

    # 4. The main path: track 3 frames rendered at known poses.
    gt_poses = [lie.apply_pose_delta(
        eye, z3, torch.tensor([0.03 * i, -0.02 * i, 0.05 * i], device=dev),
        torch.tensor([0.01 * i, 0.02 * i, -0.01 * i], device=dev))
        for i in range(3)]
    frames = []
    with torch.no_grad():
        for i, (R_gt, t_gt) in enumerate(gt_poses):
            gt = render(params["xyz"], torch.exp(params["log_scales"]),
                        params["quats"], torch.sigmoid(params["opacity_logit"]),
                        params["rgb"], R_gt, t_gt, intr,
                        tile_size=cfg.tile_size, tile_capacity=K,
                        max_dup=cfg.max_dup, max_dup_gen=cfg.max_dup_gen,
                        entry_capacity=cfg.entry_capacity, with_n_touched=False)
            pose = torch.eye(4, device=dev)
            pose[:3, :3], pose[:3, 3] = R_gt, t_gt
            frames.append(make_frame(i, gt.rgb, gt.depth, pose, device=dev))
    active = torch.ones(N, dtype=torch.bool, device=dev)
    for k in (kernels.slab_fwd, kernels.slab_bwd, kernels.rows_to_channels):
        k.launches = 0
    n_iters = 0
    for i, fr in enumerate(frames):
        R0, t0_ = lie.apply_pose_delta(
            fr.R_gt, fr.t_gt, torch.tensor([0.01, -0.008, 0.006], device=dev),
            torch.tensor([-0.004, 0.005, 0.003], device=dev))
        e0 = pose_error(R0, t0_, fr.R_gt, fr.t_gt)
        t0 = time.perf_counter()
        res = track_frame(params, active, fr._replace(R=R0, t=t0_), intr, cfg)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        e1 = pose_error(res.R, res.t, fr.R_gt, fr.t_gt)
        n_iters += int(res.n_iters)
        line("track", frame=i, iters=int(res.n_iters),
             converged=bool(res.converged), rot_err_rad=f"{e0[0]:.3e}->{e1[0]:.3e}",
             centre_err=f"{e0[1]:.3e}->{e1[1]:.3e}", s=f"{dt:.2f}",
             median_depth=f"{float(res.median_depth):.4f}",
             overflow=int(res.overflow))
        require(math.isfinite(float(res.median_depth))
                and bool(torch.isfinite(res.host_stats).all()),
                "non-finite tracking output")
        require(e1[0] < e0[0] and e1[1] < e0[1], "pose error did not shrink")
    launches = {k.__name__: k.launches for k in
                (kernels.slab_fwd, kernels.slab_bwd, kernels.rows_to_channels)}
    line("launches", iterations=n_iters, **launches)
    require(launches["slab_fwd"] >= n_iters + len(frames)
            and launches["slab_bwd"] >= n_iters
            and launches["rows_to_channels"] >= n_iters,
            "a kernel of the tracking path did not launch on it")

    # 5. Timing.
    g = torch.Generator(dev).manual_seed(4)
    rnd = make_frame(1, torch.rand((H, W, 3), generator=g, device=dev),
                     0.5 + 3.5 * torch.rand((H, W), generator=g, device=dev),
                     torch.eye(4, device=dev), device=dev)
    bcfg = TrackerConfig(max_iters=100, convergence_threshold=0.0,
                         opacity_threshold=0.5, entry_capacity=210432)
    require(int(track_frame(params, active, rnd, intr, bcfg).n_iters) == 100,
            "forced iterations did not all run")
    reps = []
    for _ in range(5):
        t0 = time.perf_counter()
        track_frame(params, active, rnd, intr, bcfg)
        torch.cuda.synchronize()
        reps.append((time.perf_counter() - t0) / 100 * 1e3)
    ms_per_iter = statistics.median(reps)
    line("timing", ms_per_iter=ms_per_iter, min=min(reps),
         max=max(reps), reps=5, card=repr(smi))
    pcfg = dataclasses.replace(bcfg, max_iters=16)
    prof = device_profile(lambda: track_frame(params, active, rnd, intr, pcfg), 16)
    if prof is None:
        line("profile", iters=16, device_busy="not measured (the profiler saw no "
             "device activity)")
    else:
        line("profile", iters=16, **{k: v for k, v in prof.items() if k != "top"},
             idle_share=1.0 - prof["device_busy_ms_per_iter"] / prof["wall_ms_per_iter"],
             card=repr(smi))
        for op, op_ms, calls in prof["top"]:
            print(f"  device: {op_ms:.4f} ms/iter  {calls:7.2f} calls/iter  {op}")

    pairs = roofline.slab_pairs(feats, bins.pstart_blk, bins.counts, rcfg)["live"]
    feat_bytes = 10 * 4 * pairs // rcfg.pixels
    track_rows = {
        "slab_fwd": (lambda: kernels.slab_fwd(*args, K, False),
                     lambda: tile_raster._fwd_slab_plain(*args, K, False), None,
                     FWD_OPS_PER_PAIR * pairs, feat_bytes + out_p.numel() * 4),
        "slab_bwd": (lambda: kernels.slab_bwd(*args[:3], baux, rcfg),
                     lambda: tile_raster._bwd_slab_plain(*args[:3], baux, rcfg), None,
                     BWD_OPS_PER_PAIR * pairs, 2 * feat_bytes + baux.numel() * 4),
        "rows_to_channels": (lambda: kernels.rows_to_channels(x),
                             lambda: tile_raster._rows_to_channels_plain(x),
                             lambda: x.t().contiguous(), 0, 2 * x.numel() * 4),
    }
    for kname, (kfn, pfn, lfn, ops, nbytes) in track_rows.items():
        t = time_kernel(kfn, pfn, lfn, ops, nbytes)
        line("kernel", shape="tracking", name=kname, **t, card=repr(smi))
    line("kernel", shape="tracking", name="slab_fwd(touched)",
         ms=cuda_ms(lambda: kernels.slab_fwd(*args, K, True), 20, graph=True),
         live_pairs=pairs, total_s=f"{time.perf_counter() - t_start:.1f}")
    track_slab = (feats, bins, rcfg)

    # 6-8. The mapping path, its kernels and the roofline probe.
    report = mapping_phases(dev, smi, launches, track_slab)
    line("done", total_s=f"{time.perf_counter() - t_start:.1f}")

    print(smi)
    print(json.dumps({"kernels": report}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
