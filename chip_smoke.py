#!/usr/bin/env python3
"""Smoke run of the PyTorch port (monogs_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line each; any failure propagates and exits non-zero:
  1. device: name, count, `nvidia-smi` name and power limit;
  2. build: nvcc of monogs_torch/csrc/composite.cu and microbench.cu
     (sm_90a, one nvcc each, started together), their -Xptxas -v reports,
     and each slab kernel's launch shape at tile 32 (threads, pixels a
     thread, blocks an SM, registers, spill bytes): no spills, slab_bwd at
     two or more blocks an SM;
 2b. the tile-binning kernels (csrc/binning.cu) against their plain twin
     on the same CUDA tensors, every TileBins field bit for bit, at the
     benchmark cells' widths (320x240, the room cut to 32,768 rows, caps
     that drop nothing) at tile 32 and tile 16; one call's device and host
     time, the twin's, the kernels a call and the output-bytes bound;
  3. kernels against their plain PyTorch twins on the card, at the
     bench.py widths (640x480, 100k Gaussians, tile 32, K 2048,
     entry_capacity 210432) and at n_img=2 on a small slab; the two
     forward variants' images bit-identical, two slab_bwd launches
     bit-identical, the tile order against its twin, no host sync in the
     tile order and slab launches, and the tiles' live chunks (max, p99,
     mean) and active warp-slot share;
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
     random images): both slab kernels at n_img 8 against their twins (and
     phase 3's bit-identity checks and live-chunk line), the batched
     relayout at (8, 131072, 16), and the roofline probe kernel for each
     op against its twin;
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
     twin, the library call and its bound (for the slab kernels also
     bound_log_ms, the bound on the log-space count of earlier PRs), at
     both shapes an A/B of the tile order net of its own launch (order +
     forward + backward against the pair in tile-id order), the probe's ns
     per step for fma / exp / log1p / div (the roofline probe's main path)
     and the slab kernels' measured-rate floors at both widths, for the
     twins' log-space work and the kernels' linear-T work, each beside its
     share of the kernel's time;
  9. the SLAM system: `python -m monogs_torch`'s main() in this process on
     configs/synthetic/room.yaml (640x480 RGB-D, the 150,000-Gaussian
     room, the config's budgets) for 16 frames with --eval and the
     synthetic cache off: fps and wall time beside the host CPU, ATE, PSNR
     and SSIM, active Gaussians and keyframes, tracking iterations, the
     profiling spans per tracked frame and per keyframe, the host reads
     per stage (under torch.cuda.set_sync_debug_mode), each kernel's
     launches (those of the ground-truth renders apart), the PLY against
     the map. It fails on a non-finite pose, ATE >= 0.05 m, PSNR <= 15 dB,
     a bad PLY, a slab kernel that did not launch, a tracker or mapper
     backend other than "slab", or a plain twin or the dense oracle called
     (a CPU tensor or the "ref" backend on the path; the binning twin
     among them), or tile_bin's kernels not launched. Then, through the
     same command line (--refine-curve 0,400), the colour refinement: the
     map evaluated before it (the PSNR line and gate above read this
     evaluation), 400 colours-only iterations, evaluated again; ms per
     iteration (synced wall), PSNR / SSIM before and after, the overflow,
     its launches, tile_bin calls and host reads, and device busy over 8
     profiled iterations. It fails on a PSNR more than 1 dB under the
     one before, a geometry leaf that moved, slab_fwd / slab_bwd not
     launched once an iteration or tile_bin not run once a span of 8, or
     more than 3 host reads;
 10. the monocular system: the same command line on
     configs/synthetic/room_mono.yaml (room.yaml without sensor depth,
     isotropic Gaussians) for 11 frames with --eval --ate-align-scale: fps,
     unaligned and scale-aligned ATE, PSNR and SSIM. It fails on an ATE
     that is not finite or not under twice the summed ground-truth motion,
     100 active Gaussians or fewer, PSNR <= 10 dB (tests/test_slam_e2e.py:
     159-190), and on phase 9's checks of the PLY, the kernels, the
     backends and the twins;
 11. the concurrent tracker / mapper mode (SLAM.run_async: the mapper on a
     thread and a CUDA stream of its own): 11a, phase 9's command line with
     --async-mode --ckpt-every 3 (no refinement; the checkpoint at keyframe
     10): fps and wall beside phase 9's, ATE / PSNR / SSIM, tracking ms a
     frame and mapping ms a keyframe beside phase 9's, the frames tracked
     while a keyframe event was in flight, the largest staleness, the
     checkpoint's write ms and bytes, peak device memory beside phase 9's,
     each kernel's launches per stream (the tracker's, the mapper's) and
     the host reads per thread; 11b, a fresh
     SLAM restores that checkpoint cold and continues run_async to frame
     16; 11c, --resume-run of 11a's directory regenerates its deleted
     metrics.json; 11d, run_async with every keyframe event in the
     bootstrap window against run() on configs/synthetic/cpu_smoke.yaml
     with the slab backend. It fails on ATE >= 0.05 m, PSNR <= 15 dB,
     phase 9's checks, a slab kernel or the relayout not launched on both
     streams, a mode other than "async", no checkpoint, a resumed
     trajectory short of frames 0-15 or its ATE >= 0.05 m, resumed figures
     off the run's (ATE 1e-9, PSNR 1e-4, SSIM 1e-5, frames and fps equal)
     or a frame loop in the --resume-run, and bootstrap poses more than
     1e-5 from run()'s or another active count;
 12. the TUM RGB-D on-disk layout: 12a, 16 frames of
     configs/synthetic/room_final.yaml's room (GT through slab_fwd) written
     in TUM's layout by monogs_torch.tools.make_tum_fixture's
     write_tum_fixture and the port's PNG writer (bytes, encode ms a frame,
     rows of each filter type); 12b, the TUM parser on it (the association
     keeps all 16 rgb frames; each frame the thinning keeps equals the
     quantised synthetic frame bit for bit, each pose within 1e-5; decode
     ms a frame); 12c, main() on a config inheriting
     configs/rgbd/tum/room_fixture.yaml with its dataset_path set to 12a's
     directory, --eval: fps, wall, ATE, PSNR, SSIM, active, tracking ms a
     frame beside phase 9's, the frame.load stage's ms a frame; 12d, cv2,
     PIL and libnvjpeg on the machine, and without cv2 the Replica, DAVIS,
     Kubric and EuRoC parsers and configs/synthetic/room_stereo.yaml's rig
     raise ImportError naming OpenCV when built (with cv2 each builds and
     reads its first frame; the rig's SGBM depth is held to the JAX
     suite's bounds against its rendered depth). It fails on a frame or
     pose off its synthetic source, ATE >= 0.05 m, PSNR <= 15 dB, phase 9's
     checks of the PLY, kernels, backends and twins, a synthetic GT render
     in 12c, a parser that builds without OpenCV or raises without naming
     it, and a first frame that is wrong where OpenCV exists;
 13. the live web viewer: a room.yaml SLAM (640x480) with start_viewer on a
     free port, 6 frames synchronous; /, /state, /render in each of the
     five shaders at the default 480x360 view (render's tile 16: the last
     tile row half outside the image), a kf= view, /screenshot (640x480)
     and /input, each 200 with an image of its size; ms per /render
     (request to bytes); then frames 6-10 under run_async while a client
     thread repeats the requests; each shader's render_fn output held
     against the CPU twin on a copy of the state (1e-5, the depth shader
     1e-4; the full view against the twin on the card at 1e-5, and at most
     VIEWER_FULL_PIXELS_OFF pixels past 1e-5 from the CPU twin) and each
     PNG (frusta off) within one level of the twin's; launches per stream,
     the viewer's apart. It fails on an answer other than 200, ATE >=
     0.05 m or PSNR <= 15 dB after the concurrent frames, a view off the
     twin, or fewer slab_fwd launches on the viewer's stream than renders;
 14. the window-sharded mapper at world size 1 on NCCL (a group of one
     rank: NCCL refuses two ranks on one card): one sharded mapping
     iteration on phase 6's state against the unsharded one (bit-identity
     reported; the gate is the CPU suite's tolerances: loss 1e-5, first
     moments at the gradient floor, xyz and statistics 1e-5, window 1e-6),
     the unsharded one against itself, ms per iteration of both, one
     reduce-scatter an iteration, its launches on a line of their own;
     then the command line on room.yaml with mesh_devices 1 for 6 frames,
     the counts set to 0 just before: check_run's checks (no twin or
     oracle called, every path kernel launched), every mapping iteration
     the sharded one, ATE < 0.05 m, PSNR > 15 dB;
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
import shutil
import statistics
import subprocess
import sys
import time
import warnings

H100_FP32_OPS = 67e12    # float32 outside the tensor cores, op/s
H100_HBM_BYTES = 3.35e12  # B/s
# The special-function units (MUFU: ex2, lg2, rcp, ...): 16 results a clock
# per SM on compute capability 9.0 (the CUDA C++ Programming Guide's
# arithmetic-throughput table), on the H100 SXM's 132 SMs at its published
# 1,980 MHz boost clock. The probe's bound_ms charges each expf as one
# FMA-pipe operation at H100_FP32_OPS; bound_sfu_ms charges its ex2 here.
H100_SFU_OPS = 16 * 132 * 1.98e9   # results/s
# float32 operations per (pixel, slot) pair, each expf, log1pf or divide as
# one operation and an fma as two (as the peak rate counts it).
# The slab kernels' own work (bound_ms). Every live pair pays for its alpha;
# the rest runs only on the pairs of a (warp, slot) with some nonzero alpha
# (roofline.active_warp_slots), as the kernels skip the others:
#   alpha:    dx, dy 2; power 9; clamp + expf 2; alpha_raw, tests, min 4 = 17
#   forward:  w 1; 4 fma + 1 add 9; 1 - alpha, the T product 2; the
#             chunk vote's log1pf and log T sum 2                        = 14
#   backward: w 1; g 8; prefix 2; 1 - alpha 1; A - prefix, divide,
#             dalpha 4; mask, dpower 3; dp dx 1; moments 6; w g_c 8;
#             the T product 1; the slot's 10 gradients and reduce-scatter
#             adds over PX = 4 pixels 6; log1pf and log T sum 2          = 43
ALPHA_OPS, FWD_REST_OPS, BWD_REST_OPS = 17, 14, 43
# The log-space count on every live pair (the plain twins' and the TPU
# kernels' work), printed as bound_log_ms so rows compare with earlier PRs:
#   forward:  alpha 17; Tk 2; w 1; acc 9; log1pf + running sum 2 = 31
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


def time_kernel(kfn, pfn, lfn, ops: float, nbytes: float, plain_reps: int = 2,
                log_ops: float | None = None) -> dict:
    """A kernel's device time (CUDA-graph replay of 20 launches) beside its
    plain twin's, the library call's where there is one, and its bound:
    the larger of ops at the float32 peak and bytes at the HBM rate; with
    `log_ops`, also bound_log_ms, the same bound on the log-space count."""
    bound_ops, bound_bytes = ops / H100_FP32_OPS * 1e3, nbytes / H100_HBM_BYTES * 1e3
    t = {"ms": cuda_ms(kfn, 20, graph=True),
         "plain_ms": cuda_ms(pfn, plain_reps, warmup=1),
         "library_ms": cuda_ms(lfn, 20, graph=True) if lfn else None,
         "bound_ms": max(bound_ops, bound_bytes),
         "bound_by": "operations" if bound_ops >= bound_bytes else "bytes"}
    if log_ops is not None:
        t["bound_log_ms"] = max(log_ops / H100_FP32_OPS * 1e3, bound_bytes)
    return t


def slab_checks(args, order, rcfg, baux, K: int, shape: str) -> None:
    """The slab kernels' bit-identity checks on one workload (args =
    (feats, pstart, counts)): the two forward variants' images, two
    slab_bwd launches, and the tile order against its twin; then the host
    syncs of one tile order + forward + backward, which must be none."""
    import torch
    from monogs_torch.ops import kernels, tile_raster

    out_hot, _ = kernels.slab_fwd(*args, order, rcfg, K, False)
    out_touched, _ = kernels.slab_fwd(*args, order, rcfg, K, True)
    d1 = kernels.slab_bwd(*args, order, baux, rcfg)
    d2 = kernels.slab_bwd(*args, order, baux, rcfg)
    order_exact = bool(torch.equal(order, tile_raster._tile_order_plain(args[2])))
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            o = kernels.tile_order(args[2])
            kernels.slab_fwd(*args, o, rcfg, K, False)
            kernels.slab_bwd(*args, o, baux, rcfg)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    syncs = sum("called a synchronizing CUDA operation" in str(w.message) for w in caught)
    torch.cuda.synchronize()
    images_equal, bwd_equal = bool(torch.equal(out_hot, out_touched)), bool(torch.equal(d1, d2))
    line("check", shape=shape, fwd_variants_bit_identical=images_equal,
         bwd_launches_bit_identical=bwd_equal, tile_order_bit_exact=order_exact,
         host_syncs_in_slab_launches=syncs)
    require(images_equal and bwd_equal and order_exact and syncs == 0,
            f"a slab bit-identity or no-sync check failed at the {shape} shape")


def tiles_line(shape: str, chunks, counts, warp_slots: dict) -> None:
    """The tiles' live chunks (roofline.live_chunks) beside their padded
    chunk counts: the spread the heaviest-first tile order works on; and
    the share of (warp, slot) pairs with some nonzero alpha
    (roofline.active_warp_slots): the kernels skip the rest."""
    import torch
    from monogs_torch.ops.binning import CHUNK

    c = chunks.to(torch.float64)
    padded = ((counts.to(torch.int64) + CHUNK - 1) // CHUNK).to(torch.float64)
    line("tiles", shape=shape, tiles=c.numel(), live_chunks_max=int(c.max()),
         live_chunks_p99=float(torch.quantile(c, 0.99)), live_chunks_mean=float(c.mean()),
         padded_chunks_max=int(padded.max()), padded_chunks_mean=float(padded.mean()),
         empty_tiles=int((counts == 0).sum()),
         active_warp_slot_share=warp_slots["active"] / max(warp_slots["total"], 1))


def order_ab(args, rcfg, baux, K: int, shape: str, smi: str) -> None:
    """CUDA-event A/B of the tile order, net of its own launch: the tile
    order alone, then the forward + backward pair as composite_slab runs it
    (one heaviest-first order built for both) against the same pair in
    tile-id order with no order launch, timed in turns (A, B, B, A; graph
    replay of 20 repetitions each)."""
    import torch
    from monogs_torch.ops import kernels

    ids = torch.arange(args[2].shape[0], dtype=torch.int32, device=args[2].device)

    def pair(o):
        kernels.slab_fwd(*args, o, rcfg, K, False)
        kernels.slab_bwd(*args, o, baux, rcfg)

    runs = {"heaviest_first": lambda: pair(kernels.tile_order(args[2])),
            "id_order": lambda: pair(ids)}
    t = {k: [] for k in runs}
    for which in ("heaviest_first", "id_order", "id_order", "heaviest_first"):
        t[which].append(cuda_ms(runs[which], 20, graph=True))
    line("ab", shape=shape, kernel="tile_order+slab_fwd+slab_bwd", what="tile order",
         tile_order_ms=cuda_ms(lambda: kernels.tile_order(args[2]), 20, graph=True),
         heaviest_first_ms=statistics.mean(t["heaviest_first"]),
         id_order_ms=statistics.mean(t["id_order"]), card=repr(smi))


# The benchmark's cells (slambench/configs/room-rgbd-320.yaml): 320x240 at
# TUM fr3's field of view, a map of 32,768 rows, caps that drop nothing.
BIN_W, BIN_H, BIN_ROWS, BIN_FRAME = 320, 240, 32_768, 40
BIN_CAPS = dict(tile_capacity=16_384, max_dup=300, max_dup_gen=300, entry_capacity=1_310_720)


def binning_phase(smi: str = "") -> None:
    """Phase 2b: the tile-binning kernels (csrc/binning.cu) against their
    plain twin on the same CUDA tensors, every TileBins field bit for bit,
    at the cells' widths: the room (roofline.room_projection, BIN_ROWS rows
    at orbit frame BIN_FRAME) binned at tile 32 (the tracker's and the
    window's binning, T 80) and tile 16 (the keyframe extend's, T 300);
    then, at each, one call's device time (CUDA-graph replay of 20 calls),
    its host time (20 calls, synced), the twin's device time, the kernels
    launched a call (profiler) beside the twin's, and the bound: the bytes
    of the outputs at the HBM rate."""
    import torch
    from monogs_torch.ops import binning, kernels
    from monogs_torch.ops.graphics import Intrinsics
    from monogs_torch.tools import roofline

    dev = torch.device("cuda")
    intr = Intrinsics(fx=267.7, fy=269.6, cx=159.8, cy=123.55, width=BIN_W, height=BIN_H)
    p = roofline.room_projection(BIN_ROWS, BIN_FRAME, intr, dev)
    for tile, shape in ((32, "tracking/mapping"), (16, "extend")):
        tx, ty = -(-BIN_W // tile), -(-BIN_H // tile)
        K, P_cap = BIN_CAPS["tile_capacity"], BIN_CAPS["entry_capacity"]

        def kern():
            return binning.tile_bin(None, p.radius, p.depth, p.valid, img_w=BIN_W, img_h=BIN_H,
                                    tile_size=tile, opacity=p.opacity, conic=(p.ca, p.cb, p.cc),
                                    uv=(p.u, p.v), **BIN_CAPS)

        def launch():
            return kernels.tile_bin(p.u, p.v, p.radius, p.depth, p.valid, p.opacity,
                                    (p.ca, p.cb, p.cc), tiles_x=tx, tiles_y=ty,
                                    tile_size=tile, K=K, max_dup=BIN_CAPS["max_dup"],
                                    max_dup_gen=BIN_CAPS["max_dup_gen"], P_cap=P_cap,
                                    cull_alpha=binning.ALPHA_EPS)

        def plain():
            return binning._tile_bin_plain(p.u, p.v, p.radius, p.depth, p.valid, p.opacity,
                                           (p.ca, p.cb, p.cc), tx, ty, tile, K,
                                           BIN_CAPS["max_dup"], BIN_CAPS["max_dup_gen"],
                                           P_cap, binning.ALPHA_EPS)

        got, want = kern(), plain()
        torch.cuda.synchronize()
        same = {f: bool(torch.equal(getattr(got, f), getattr(want, f)))
                for f in binning.TileBins._fields}
        line("check", kernel="tile_bin", shape=shape, tile=tile, tiles=tx * ty,
             bit_identical=all(same.values()), entries=int(want.counts.sum()),
             overflow=int(want.overflow), visible=int(p.valid.sum()),
             fields_off=[f for f, ok in same.items() if not ok])
        require(all(same.values()), f"tile_bin's kernels differ from the twin at tile {tile}")
        out_bytes = 4 * sum(getattr(want, f).numel() for f in binning.TileBins._fields)
        t0 = time.perf_counter()
        for _ in range(20):
            kern()
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) / 20 * 1e3
        prof_k, prof_p = device_profile(kern, 1, top=12), device_profile(plain, 1)
        # The launcher alone under the graph: the `bin` span around it reads
        # its events back, which a stream capture does not allow.
        line("kernel", name="tile_bin", shape=shape, tile=tile, rows=BIN_ROWS,
             ms=cuda_ms(launch, 20, graph=True), host_ms=host_ms,
             plain_ms=cuda_ms(plain, 3, warmup=1),
             bound_ms=out_bytes / H100_HBM_BYTES * 1e3, bound_by="bytes",
             out_bytes=out_bytes,
             launches=prof_k and prof_k["device_launches_per_iter"],
             plain_launches=prof_p and prof_p["device_launches_per_iter"], card=repr(smi))
        if prof_k is not None:
            for op, op_ms, calls in prof_k["top"]:
                print(f"  device: {op_ms:.4f} ms/call  {calls:5.2f} calls/call  {op}")
    for ln in kernels.build_log("binning").splitlines():
        if "registers" in ln or "spill" in ln:
            print("  ptxas (binning):", ln.strip().removeprefix("ptxas info    : "))


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
    args = (feats, pstart, counts)
    order = kernels.tile_order(counts)
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

    out_k, _ = kernels.slab_fwd(*args, order, rcfg, K, False)
    out_kt, touched_k = kernels.slab_fwd(*args, order, rcfg, K, True)
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
    d_k = kernels.slab_bwd(*args, order, baux, rcfg)
    d_p = bwd_plain(baux)
    torch.cuda.synchronize()
    err_bwd, ok = bwd_err(d_k, d_p)
    line("check", kernel="slab_bwd", shape="mapping", n_img=WIN, max_abs_err=err_bwd,
         max_abs_plain=float(d_p.abs().max()))
    require(ok, "slab_bwd disagrees with its twin at n_img 8")
    slab_checks(args, order, rcfg, baux, K, "mapping")
    m_chunks = torch.cat([roofline.live_chunks(feats, pstart[w * T:(w + 1) * T],
                                               counts[w * T:(w + 1) * T], rcfg)
                          for w in range(WIN)])
    m_slots = [roofline.active_warp_slots(feats, pstart[w * T:(w + 1) * T],
                                          counts[w * T:(w + 1) * T], rcfg)
               for w in range(WIN)]
    m_slots = {k: sum(d[k] for d in m_slots) for k in ("active", "total")}
    tiles_line("mapping", m_chunks, counts, m_slots)
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
    path = (kernels.slab_fwd, kernels.slab_bwd, kernels.rows_to_channels, kernels.tile_order)
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
            and map_launches["rows_to_channels"] >= M_ITERS
            and map_launches["tile_order"] == map_launches["slab_fwd"],
            "a kernel of the mapping path did not launch on it (or the tile order "
            "was not built once per forward)")

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

    pairs = int(m_chunks.sum()) * roofline.CHUNK * rcfg.pixels
    pairs_path = window_pairs(*window_slab(state0, intr, cfg)[1:], rcfg)
    line("pairs", shape="mapping", live_pairs_timed=pairs, opacity_logits_timed="N(0,1)",
         live_pairs_event_path=pairs_path,
         opacity_logits_event_path=f"N({PATH_OPACITY_SHIFT},1)")
    active = m_slots["active"] * roofline.WARP_PIXELS
    feat_bytes = 10 * 4 * pairs // rcfg.pixels
    rows = {
        "slab_fwd": ("cuda", "monogs_torch/csrc/composite.cu",
                     "monogs_tpu/ops/tile_raster.py:284 (_slab_fwd_kernel, via _fwd_slab :467)",
                     lambda: kernels.slab_fwd(*args, order, rcfg, K, False),
                     lambda: fwd_plain(False), None,
                     ALPHA_OPS * pairs + FWD_REST_OPS * active, FWD_OPS_PER_PAIR * pairs,
                     feat_bytes + out_p.numel() * 4, err_fwd),
        "slab_bwd": ("cuda", "monogs_torch/csrc/composite.cu",
                     "monogs_tpu/ops/tile_raster.py:355 (_slab_bwd_kernel, via _bwd_slab :517)",
                     lambda: kernels.slab_bwd(*args, order, baux, rcfg),
                     lambda: bwd_plain(baux), None,
                     ALPHA_OPS * pairs + BWD_REST_OPS * active, BWD_OPS_PER_PAIR * pairs,
                     2 * feat_bytes + baux.numel() * 4, err_bwd),
        "rows_to_channels": ("triton", "monogs_torch/csrc/relayout.py",
                             "monogs_tpu/ops/tile_raster.py:622 (rows_to_channels / "
                             "_relayout_kernel :618, vmapped in _pfw_bwd :792)",
                             lambda: kernels.rows_to_channels(xw),
                             lambda: tile_raster._rows_to_channels_plain(xw),
                             lambda: xw.transpose(1, 2).contiguous(), 0, None,
                             2 * xw.numel() * 4, 0.0),
    }
    report = []
    for kname, (route, source, replaces, kfn, pfn, lfn, ops, log_ops, nbytes,
                err) in rows.items():
        t = time_kernel(kfn, pfn, lfn, ops, nbytes, log_ops=log_ops)
        report.append({"name": kname, "route": route, "source": source,
                       "replaces": replaces,
                       "launches": track_launches[kname] + map_launches[kname],
                       "launches_tracking": track_launches[kname],
                       "launches_mapping": map_launches[kname],
                       "shape": "mapping", "max_abs_err": err, **t})
        line("kernel", shape="mapping", name=kname, **t,
             launches_per_mapping_iter=per_iter[kname], card=repr(smi))
    line("kernel", shape="mapping", name="slab_fwd(touched)",
         ms=cuda_ms(lambda: kernels.slab_fwd(*args, order, rcfg, K, True), 20, graph=True),
         live_pairs=pairs, active_pairs=active)
    order_ab(args, rcfg, baux, K, "mapping", smi)

    # The roofline probe's main path: the four rates at the probe shape.
    kernels.op_microbench.launches = 0
    rates = {op: roofline.op_microbench(op) for op in roofline.OPS}
    probe_launches = kernels.op_microbench.launches
    line("roofline", **{f"{op}_ns_per_step": v for op, v in rates.items()},
         shape=roofline.PROBE_SHAPE, n_rep=roofline.PROBE_REP,
         lanes=roofline.PROBE_LANES, launches=probe_launches, card=repr(smi))
    require(probe_launches == 4 * len(roofline.OPS), "the probe kernel did not launch")
    t_pairs, t_active, track_ms = track_slab
    map_ms = {r["name"]: r["ms"] for r in report}
    for shape, n, n_active, ms in (("tracking", t_pairs, t_active, track_ms),
                                   ("mapping", pairs, active, map_ms)):
        for mix in roofline.MIXES:
            f = roofline.floors_ms(n, rates, mix, n_active)
            line("floor", shape=shape, mix=mix, live_pairs=n, active_pairs=n_active, **f,
                 fwd_share=f["floor_fwd_ms"] / ms["slab_fwd"],
                 bwd_share=f["floor_bwd_ms"] / ms["slab_bwd"], card=repr(smi))
    steps = xp.numel() * roofline.PROBE_REP * roofline.PROBE_LANES
    t = time_kernel(lambda: kernels.op_microbench(xp, "exp", roofline.PROBE_REP,
                                                  roofline.PROBE_LANES),
                    lambda: roofline.op_chain_plain(xp, "exp", roofline.PROBE_REP,
                                                    roofline.PROBE_LANES),
                    None, 3 * steps, (xp.numel() + xp[0].numel()) * 4, plain_reps=1)
    t["bound_sfu_ms"] = steps / H100_SFU_OPS * 1e3
    line("kernel", name="op_microbench(exp)", **t, card=repr(smi))
    report.append({"name": "op_microbench", "route": "cuda",
                   "source": "monogs_torch/csrc/microbench.cu",
                   "replaces": "scripts/bench_roofline.py:44 (op_microbench, "
                               "pl.pallas_call :86)",
                   "launches": probe_launches, "launches_roofline": probe_launches,
                   "shape": "probe", "max_abs_err": max(probe_err.values()), **t})
    return report


# Phase 9: `python -m monogs_torch` on the flagship synthetic config, cut to
# its first 16 frames (keyframes 0, 5, 10, 15: the map initialisation and
# three mapping events); every other budget is the config's own. Then the
# colour refinement through the same command line: the map is evaluated
# before any refinement (milestone 0) and after 400 colours-only iterations
# (50 spans of 8), the cut of the 3,000-iteration protocol for time.
REFINE_ITERS, REFINE_SPAN = 400, 8
SYSTEM_ARGV = ["--config", "configs/synthetic/room.yaml", "--n-frames", "16", "--eval",
               "--device", "cuda", "--backend", "slab", "--refine-curve", f"0,{REFINE_ITERS}"]
SYSTEM_ATE_MAX, SYSTEM_PSNR_MIN = 0.05, 15.0   # tests/test_slam_e2e.py:75,87
REFINE_PSNR_DROP = 1.0                         # tests/test_slam_e2e.py:113
# The refinement's host reads: the keyframes' poses and exposures staged in
# one copy, and the overflow read at 200 and 400 iterations.
REFINE_READS_MAX = 3
# Phase 10: the monocular room (configs/synthetic/room_mono.yaml: the same
# scene and orbit, no sensor depth, isotropic Gaussians) for 11 frames,
# keyframes 0, 5 and 10: the map initialisation and two mapping events,
# with the monocular protocol's scale-aligned ATE. Its bounds are
# tests/test_slam_e2e.py:159-190's.
MONO_ARGV = ["--config", "configs/synthetic/room_mono.yaml", "--n-frames", "11", "--eval",
             "--ate-align-scale", "--device", "cuda", "--backend", "slab"]
MONO_PSNR_MIN, MONO_ACTIVE_MIN = 10.0, 100
# Where a host read (an implicit device sync) lands, by the innermost SLAM
# method on the reading thread's stack.
READ_STAGE = {"track": "tracking", "_mapper_keyframe": "keyframe",
              "_apply_mapper_result": "keyframe", "process_frame": "keyframe",
              "initialize": "init", "_load_frame_impl": "load", "render_at": "eval",
              "eval_rendering": "eval", "save_map": "export", "run": "run",
              "refine": "refine", "_maybe_checkpoint": "checkpoint",
              "run_async": "run"}


def host_cpu() -> str:
    try:
        with open("/proc/cpuinfo") as f:
            for ln in f:
                if ln.startswith("model name"):
                    return ln.split(":", 1)[1].strip()
    except OSError:
        pass
    return "unknown"


def drive_cli(argv: list) -> tuple[dict, dict]:
    """`python -m monogs_torch`'s main(argv) in this process, with every
    kernel's launch count set to 0 just before and read just after, the
    synthetic disk cache off (so the ground truth renders through the
    kernels), and counted: the plain twins' and the dense oracle's calls
    (a CPU tensor or the "ref" backend on the path), the ground-truth
    renders and their slab_fwd launches, the host reads per stage (under
    torch.cuda.set_sync_debug_mode), and inside `SLAM.refine` alone: its
    synced wall time, the kernels' launches, the `tile_bin` calls and the
    host reads, beside a copy of the map's geometry leaves taken when it
    starts.
    -> (main's summary, counts)."""
    import threading
    import traceback

    import torch
    from monogs_torch.__main__ import main as slam_main
    from monogs_torch.data.synthetic import SyntheticDataset
    from monogs_torch.ops import binning, kernels, render, tile_raster
    from monogs_torch.slam import mapper
    from monogs_torch.slam.system import SLAM

    os.environ["MONOGS_SYNTH_CACHE"] = "0"
    counted = (kernels.slab_fwd, kernels.slab_bwd, kernels.rows_to_channels,
               kernels.tile_order, kernels.op_microbench, kernels.tile_bin)
    kernels.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    # Each twin, the oracle and tile_bin are counted in the module whose
    # code calls them: the slab twins in tile_raster's dispatchers, the
    # binning twin in binning.tile_bin's, the
    # oracle and the render's binning in render.py and the refinement's
    # binning in mapper.py, which import them by name. (The tile order's
    # twin is reached only from the card tests and phase 3.) The GT
    # renders' slab_fwd launches are told apart by a thread-local flag set
    # around the dataset's render.
    patched = ((tile_raster, "_fwd_slab_plain"), (tile_raster, "_bwd_slab_plain"),
               (tile_raster, "_rows_to_channels_plain"), (render, "composite_tiles_ref"),
               (binning, "_tile_bin_plain"),
               (tile_raster, "_fwd_slab"), (render, "tile_bin"), (mapper, "tile_bin"))
    twins = tuple(n for _, n in patched[:5])
    twin_calls = {n: 0 for n in twins}
    saved = {(mod.__name__, n): getattr(mod, n) for mod, n in patched}
    saved_render, saved_refine = SyntheticDataset._render_pose, SLAM.refine
    in_gt = threading.local()
    gt = {"renders": 0, "slab_fwd": 0}
    bins = {"render": 0, "mapper": 0}
    reads, reads_by_thread = {}, {}
    refine = {"calls": 0, "iters": 0, "s": 0.0, "tile_bin": 0, "geometry": None,
              "launches": {k.__name__: 0 for k in counted}}

    def count_twin(mod, name):
        def call(*a, **kw):
            twin_calls[name] += 1
            return saved[(mod.__name__, name)](*a, **kw)
        return call

    def count_bin(mod, where):
        def call(*a, **kw):
            bins[where] += 1
            return saved[(mod.__name__, "tile_bin")](*a, **kw)
        return call

    def fwd_slab(*a, **kw):
        if getattr(in_gt, "on", False) and a[0].is_cuda:
            gt["slab_fwd"] += 1
        return saved[(tile_raster.__name__, "_fwd_slab")](*a, **kw)

    def render_pose(self, *a, **kw):
        in_gt.on = True
        gt["renders"] += 1
        try:
            return saved_render(self, *a, **kw)
        finally:
            in_gt.on = False

    def refine_counted(self, iters=None):
        if refine["geometry"] is None:
            refine["geometry"] = {k: v.clone() for k, v in self.state.gmap.params.items()
                                  if k not in mapper.REFINE_LEAVES}
        torch.cuda.synchronize()
        before = {k.__name__: k.launches for k in counted}
        bins0 = sum(bins.values())
        t0 = time.perf_counter()
        saved_refine(self, iters)
        torch.cuda.synchronize()
        refine["s"] += time.perf_counter() - t0
        refine["calls"] += 1
        refine["iters"] += self.mcfg.refine_iters if iters is None else iters
        refine["tile_bin"] += sum(bins.values()) - bins0
        for k in counted:
            refine["launches"][k.__name__] += k.launches - before[k.__name__]

    sync_warn = "called a synchronizing CUDA operation"

    def on_warning(message, category, filename, lineno, file=None, line_=None):
        if sync_warn not in str(message):
            return
        stack = traceback.extract_stack()
        stage = "other"
        for fr in reversed(stack):
            if fr.filename.endswith(os.path.join("slam", "system.py")) and fr.name in READ_STAGE:
                stage = READ_STAGE[fr.name]
                break
        reads[stage] = reads.get(stage, 0) + 1
        key = f"{threading.current_thread().name}:{stage}"
        reads_by_thread[key] = reads_by_thread.get(key, 0) + 1

    for mod, n in patched[:5]:
        setattr(mod, n, count_twin(mod, n))
    tile_raster._fwd_slab = fwd_slab
    render.tile_bin = count_bin(render, "render")
    mapper.tile_bin = count_bin(mapper, "mapper")
    SyntheticDataset._render_pose = render_pose
    SLAM.refine = refine_counted
    t0 = time.perf_counter()
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("always")
            warnings.showwarning = on_warning
            torch.cuda.set_sync_debug_mode("warn")
            try:
                out = slam_main(argv)
            finally:
                torch.cuda.set_sync_debug_mode("default")
    finally:
        for mod, n in patched:
            setattr(mod, n, saved[(mod.__name__, n)])
        SyntheticDataset._render_pose = saved_render
        SLAM.refine = saved_refine
    torch.cuda.synchronize()
    return out, {"phase_s": time.perf_counter() - t0,
                 "launches": {k.__name__: k.launches for k in counted},
                 "launches_by_stream": {k.__name__: dict(k.by_stream) for k in counted},
                 "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
                 "twin_calls": twin_calls, "gt": gt, "reads": reads,
                 "reads_by_thread": reads_by_thread, "refine": refine}


def check_run(out: dict, c: dict, smi: str, path: str, synthetic: bool = True) -> dict:
    """The checks every command-line phase shares, with their lines: poses
    finite, the PLY equal to the map, the slab kernels launched, the ground
    truth rendered through slab_fwd (synthetic=False: no ground-truth render
    at all, the frames come from files), both backends "slab", no plain twin
    or dense oracle called and nothing off the card. -> a few figures."""
    import numpy as np
    from monogs_torch.utils.ply import load_ply

    slam, launches, gt = out["slam"], c["launches"], c["gt"]
    poses = np.stack([np.concatenate([R.ravel(), t]) for R, t in slam.est_poses.values()])
    finite = bool(np.isfinite(poses).all())
    ply = load_ply(os.path.join(out["save_dir"], "point_cloud", "final", "point_cloud.ply"))
    active = slam.state.gmap.active
    xyz_map = slam.state.gmap.params["xyz"][active].cpu().numpy()
    ply_ok = ply["xyz"].shape[0] == out["map_active"] > 0 and np.array_equal(ply["xyz"], xyz_map)
    on_card = [k for k, v in slam.state.gmap.params.items() if not v.is_cuda] + [
        f for f, v in zip(slam.state.window.frames._fields, slam.state.window.frames)
        if not v.is_cuda]
    n_tracked, n_kf = len(slam.metrics["tracking_iters"]), out["n_keyframes"] - 1
    reads = c["reads"]
    line(path, host_reads=repr(reads),
         reads_per_tracked_frame=reads.get("tracking", 0) / n_tracked,
         reads_per_keyframe=reads.get("keyframe", 0) / max(n_kf, 1),
         note="read counts taken under torch.cuda.set_sync_debug_mode; the frame-load "
              "reads are " + ("the GT renders' image reads" if synthetic
                              else "the frames' host-to-device copies"))
    line("launches", path=path, gt_renders=gt["renders"], gt_slab_fwd=gt["slab_fwd"],
         twin_calls=sum(c["twin_calls"].values()), **launches)
    line(path, ply_vertices=ply["xyz"].shape[0], num_active=out["map_active"],
         ply_matches_map=ply_ok, poses_finite=finite, card=repr(smi))
    require(finite, f"{path}: a frame's pose is not finite")
    require(ply_ok, f"{path}: the PLY is empty or disagrees with the map")
    require(launches["slab_fwd"] > 0 and launches["slab_bwd"] > 0
            and launches["rows_to_channels"] > 0 and launches["tile_order"] > 0
            and launches["tile_bin"] > 0,
            f"{path}: a kernel of the system path did not launch")
    if synthetic:
        require(gt["renders"] >= out["n_frames"] and gt["slab_fwd"] >= gt["renders"],
                f"{path}: the ground truth did not render through slab_fwd")
    else:
        require(gt["renders"] == 0, f"{path}: a synthetic ground truth rendered")
    require(slam.tcfg.backend == slam.mcfg.backend == "slab",
            f"{path}: the system ran backends {slam.tcfg.backend!r} / "
            f"{slam.mcfg.backend!r}, not 'slab'")
    require(not any(c["twin_calls"].values()) and not on_card,
            f"{path}: the system path touched CPU tensors: twins {c['twin_calls']}, "
            f"off the card {on_card}")
    return {"n_tracked": n_tracked, "n_kf": n_kf}


def system_phase(smi: str) -> tuple[dict, dict]:
    """Phase 9: the synchronous SLAM system on the card, through the
    command line's main() in this process: 16 frames of
    configs/synthetic/room.yaml at its full width (640x480, the 150,000-
    Gaussian room, tracking 100 / mapping 150 / init 1,050 iterations,
    window 8, entry capacity 225,280), --eval, then --refine-curve 0,400:
    the map evaluated, refined 400 colours-only iterations and evaluated
    again. Fails on a non-finite pose, ATE >= 0.05 m, PSNR <= 15 dB before
    the refinement, a refined PSNR more than 1 dB under it, a geometry leaf
    that the refinement moved, a refinement that did not launch slab_fwd
    and slab_bwd once an iteration and tile_bin once a span, more than 3
    host reads in it, and on check_run's checks.
    -> (each kernel's launches in the frame loop and evals, in the
    refinement)."""
    import torch
    from monogs_torch.slam.mapper import refine_span

    out, c = drive_cli(SYSTEM_ARGV)
    slam, stages, rf = out["slam"], out["stages"], c["refine"]
    figures = check_run(out, c, smi, "system")
    its = slam.metrics["tracking_iters"]
    curve = {e["iters"]: e for e in out["refine_curve"]}
    before, after = curve[0], curve[REFINE_ITERS]
    with open(os.path.join(out["save_dir"], "psnr", "refine0", "final_result.json")) as f:
        ev = json.load(f)
    track_ms = sum(stages[k]["total_s"] for k in ("track.dispatch", "track.readback")) \
        / figures["n_tracked"] * 1e3
    kf_ms = sum(v["total_s"] for k, v in stages.items() if k.startswith("kf.")) \
        / figures["n_kf"] * 1e3
    line("system", config=SYSTEM_ARGV[1], frames=out["n_frames"], fps=out["fps"],
         wall_s=out["wall_s"], phase_s=f"{c['phase_s']:.1f}", host_cpu=repr(host_cpu()),
         host_cpus=os.cpu_count(), peak_mem_gib=c["peak_mem_gib"], card=repr(smi))
    line("system", ate_rmse=out["final_ate_rmse"], psnr=ev["mean_psnr"], ssim=ev["mean_ssim"],
         eval_frames=ev["n_frames"], train_view_inflated=ev.get("train_view_inflated", False),
         active=out["map_active"], keyframes=out["n_keyframes"],
         kf_history=sorted(slam.kf_history), window=slam.kf_list)
    line("system", tracking_iters_mean=out["tracking_iters_mean"], tracking_iters_max=max(its),
         tracking_ms_per_frame=track_ms, mapping_ms_per_keyframe=kf_ms,
         init_s=stages["init"]["total_s"], overflow_max=out["overflow_max"],
         entry_capacity=(slam.tcfg.entry_capacity, slam.mcfg.entry_capacity))
    for k, v in sorted(stages.items()):
        print(f"  stage: {k:18s} n={v['n']:3d} total_s={v['total_s']:.3f} "
              f"mean_ms={v['mean_ms']:.2f}")

    # The refinement: geometry untouched, one binning a span, one launch of
    # each slab kernel an iteration, sparse reads; then 8 more iterations
    # (one span) under the profiler, after the counts are read.
    geometry_same = all(torch.equal(v, slam.state.gmap.params[k])
                        for k, v in rf["geometry"].items())
    n_spans = -(-REFINE_ITERS // REFINE_SPAN)
    refine_reads = c["reads"].get("refine", 0)
    line("refine", iters=rf["iters"], calls=rf["calls"],
         ms_per_iter=rf["s"] * 1e3 / max(rf["iters"], 1),
         psnr_before=before["psnr"], psnr_after=after["psnr"], ssim_before=before["ssim"],
         ssim_after=after["ssim"], refine_overflow_max=out.get("refine_overflow_max"),
         tile_bin=rf["tile_bin"], host_reads=refine_reads, geometry_bit_identical=geometry_same,
         card=repr(smi))
    line("launches", path="refine", **rf["launches"])
    kf = sorted(slam.kf_history)[0]
    frame = slam._fetch_frame_at_pose(kf)
    prof = device_profile(
        lambda: refine_span(slam.state, frame, slam.intr, slam.mcfg, REFINE_SPAN), REFINE_SPAN)
    if prof is not None:
        line("profile", path="refine", iters=REFINE_SPAN,
             **{k: v for k, v in prof.items() if k != "top"},
             idle_share=1.0 - prof["device_busy_ms_per_iter"] / prof["wall_ms_per_iter"],
             card=repr(smi))
        for op, op_ms, calls in prof["top"]:
            print(f"  device: {op_ms:.4f} ms/iter  {calls:7.2f} calls/iter  {op}")

    require(out["final_ate_rmse"] < SYSTEM_ATE_MAX,
            f"ATE {out['final_ate_rmse']:.4f} m is not under {SYSTEM_ATE_MAX}")
    require(ev["mean_psnr"] > SYSTEM_PSNR_MIN,
            f"PSNR {ev['mean_psnr']:.2f} dB is not over {SYSTEM_PSNR_MIN}")
    require(rf["iters"] == REFINE_ITERS and after["psnr"] > before["psnr"] - REFINE_PSNR_DROP,
            f"refinement: {rf['iters']} iterations, PSNR {before['psnr']:.3f} -> "
            f"{after['psnr']:.3f} dB")
    require(geometry_same, "colours-only refinement moved a geometry leaf")
    require(rf["launches"]["slab_fwd"] == rf["launches"]["slab_bwd"] == REFINE_ITERS
            and rf["tile_bin"] == n_spans,
            f"refinement launched slab_fwd / slab_bwd {rf['launches']['slab_fwd']} / "
            f"{rf['launches']['slab_bwd']} times and ran tile_bin {rf['tile_bin']} times, "
            f"not {REFINE_ITERS} / {REFINE_ITERS} / {n_spans}")
    require(refine_reads <= REFINE_READS_MAX,
            f"refinement made {refine_reads} host reads (at most {REFINE_READS_MAX})")
    require(prof is not None, "the profiler saw no device work in the refinement")
    loop = {k: v - rf["launches"][k] for k, v in c["launches"].items()}
    sync = {"fps": out["fps"], "wall_s": out["wall_s"], "peak_mem_gib": c["peak_mem_gib"],
            "track_ms": track_ms, "kf_ms": kf_ms}
    return loop, rf["launches"], sync


def mono_phase(smi: str) -> dict:
    """Phase 10: the monocular system on the card, through the command
    line's main() in this process: 11 frames of
    configs/synthetic/room_mono.yaml (room.yaml without sensor depth, with
    isotropic Gaussians) with --eval --ate-align-scale. Fails on an ATE
    that is not finite or not under twice the summed ground-truth motion,
    100 active Gaussians or fewer, PSNR <= 10 dB, and on check_run's
    checks. -> each kernel's launches in the phase."""
    import numpy as np

    out, c = drive_cli(MONO_ARGV)
    slam = out["slam"]
    check_run(out, c, smi, "mono")
    with open(os.path.join(out["save_dir"], "psnr", "final", "final_result.json")) as f:
        ev = json.load(f)
    with open(os.path.join(out["save_dir"], "plot", "stats_aligned_scale.json")) as f:
        ate_scale = json.load(f)["rmse"]
    # The summed motion as tests/test_slam_e2e.py:181-186 sums it.
    gt = [slam.gt_poses[i][1] for i in sorted(slam.gt_poses)]
    motion = float(sum(np.linalg.norm(b - a) for a, b in zip(gt, gt[1:])))
    ate = out["final_ate_rmse"]
    line("mono", config=MONO_ARGV[1], frames=out["n_frames"], fps=out["fps"],
         wall_s=out["wall_s"], phase_s=f"{c['phase_s']:.1f}", monocular=slam.mcfg.monocular,
         card=repr(smi))
    line("mono", ate_rmse=ate, ate_scale_aligned=ate_scale, gt_motion=motion,
         psnr=ev["mean_psnr"], ssim=ev["mean_ssim"], eval_frames=ev["n_frames"],
         active=out["map_active"], keyframes=out["n_keyframes"],
         kf_history=sorted(slam.kf_history),
         tracking_iters_mean=out["tracking_iters_mean"], init_s=out["stages"]["init"]["total_s"])
    require(slam.mcfg.monocular and slam.dataset[0].get("depth") is None,
            "phase 10 did not run the monocular path")
    require(np.isfinite(ate) and ate < 2.0 * motion,
            f"mono ATE {ate} is not finite and under twice the motion {motion:.4f}")
    require(out["map_active"] > MONO_ACTIVE_MIN,
            f"mono map has {out['map_active']} active Gaussians")
    require(ev["mean_psnr"] > MONO_PSNR_MIN,
            f"mono PSNR {ev['mean_psnr']:.2f} dB is not over {MONO_PSNR_MIN}")
    return c["launches"]


# Phase 11: phase 9's run with the tracker and the mapper concurrent, a
# checkpoint every 3 keyframes (keyframes 0, 5, 10, 15: one, at frame 10,
# mid-run, so the cold resume has frames 11-15 to track), then the resumes;
# and the bootstrap equivalence on the small CPU config (async_bootstrap_kfs
# 99 holds every keyframe event, so run_async does run()'s operations).
ASYNC_ARGV = ["--config", "configs/synthetic/room.yaml", "--n-frames", "16", "--async-mode",
              "--ckpt-every", "3", "--eval", "--device", "cuda", "--backend", "slab"]
RESUME_RUN_ARGV = ["--async-mode", "--n-frames", "16", "--eval"]
EQUIV_CONFIG, EQUIV_POSE_TOL = "configs/synthetic/cpu_smoke.yaml", 1e-5


def _slam_of(config_path: str, backend: str = "slab", **system):
    """A SLAM on the card from a config file, as the command line builds it
    (its save_dir cleared; `system` overrides SystemConfig fields)."""
    from monogs_torch.data import load_dataset
    from monogs_torch.slam.system import SLAM
    from monogs_torch.utils import config as uc

    cfg = uc.load_config(config_path)
    scfg = dataclasses.replace(uc.build_system_config(cfg), save_dir=None, **system)
    slam = SLAM(load_dataset(cfg, device="cuda"), config=cfg,
                tracker_config=uc.build_tracker_config(cfg, backend=backend),
                mapper_config=uc.build_mapper_config(cfg, backend=backend),
                keyframe_config=uc.build_keyframe_config(cfg), system_config=scfg,
                device="cuda")
    slam.prewarm()
    return slam


def async_phase(smi: str, sync: dict) -> dict:
    """Phase 11, the concurrent tracker / mapper mode on the card.
    11a: phase 9's command line with --async-mode --ckpt-every 3 (no
    refinement): fps and wall beside phase 9's, ATE / PSNR / SSIM, tracking
    ms a frame, mapping ms a keyframe, frames tracked while an event was in
    flight, the largest staleness (frames tracked between a keyframe's
    message and its result's application), the checkpoint's write ms and
    bytes, peak device memory beside phase 9's, each kernel's launches per
    stream and the host reads per thread; fails on ATE >= 0.05 m, PSNR <= 15 dB,
    check_run's checks, a slab kernel or the relayout not launched on both
    the tracker's and the mapper's stream, and metrics.json's mode not
    "async". 11b: a fresh SLAM restores 11a's checkpoint cold and continues
    run_async to frame 16; fails unless the trajectory covers frames 0-15,
    ATE < 0.05 m and more than 100 Gaussians are active. 11c: 11a's
    metrics.json and psnr/ deleted, --resume-run must regenerate them (ATE
    to 1e-9, PSNR 1e-4, SSIM 1e-5, frames and fps equal) with no slab_bwd
    launch. 11d: on configs/synthetic/cpu_smoke.yaml with the slab backend,
    run_async with async_bootstrap_kfs 99 against run(): poses within 1e-5,
    the same active count. -> 11a's launches of each kernel."""
    import numpy as np
    import torch
    from monogs_torch.ops import kernels
    from monogs_torch.utils.ckpt import load_checkpoint

    # 11a.
    out, c = drive_cli(ASYNC_ARGV)
    slam, stages = out["slam"], out["stages"]
    figures = check_run(out, c, smi, "async")
    with open(os.path.join(out["save_dir"], "metrics.json")) as f:
        metrics = json.load(f)
    with open(os.path.join(out["save_dir"], "psnr", "final", "final_result.json")) as f:
        ev = json.load(f)
    ckpt_dir = os.path.join(out["save_dir"], "ckpt")
    ckpt_bytes = sum(os.path.getsize(os.path.join(ckpt_dir, n)) for n in os.listdir(ckpt_dir))
    track_ms = sum(stages[k]["total_s"] for k in ("track.dispatch", "track.readback")) \
        / figures["n_tracked"] * 1e3
    kf_ms = sum(v["total_s"] for k, v in stages.items() if k.startswith("kf.")) \
        / figures["n_kf"] * 1e3
    staleness = slam.metrics["async_staleness"]
    line("async", config=ASYNC_ARGV[1], frames=out["n_frames"], fps=out["fps"],
         wall_s=out["wall_s"], sync_fps=sync["fps"], sync_wall_s=sync["wall_s"],
         phase_s=f"{c['phase_s']:.1f}", host_cpu=repr(host_cpu()), host_cpus=os.cpu_count(),
         card=repr(smi))
    line("async", ate_rmse=out["final_ate_rmse"], psnr=ev["mean_psnr"], ssim=ev["mean_ssim"],
         eval_frames=ev["n_frames"], active=out["map_active"], keyframes=out["n_keyframes"],
         kf_history=sorted(slam.kf_history), mode=metrics["mode"])
    line("async", tracking_ms_per_frame=track_ms, sync_tracking_ms_per_frame=sync["track_ms"],
         mapping_ms_per_keyframe=kf_ms, sync_mapping_ms_per_keyframe=sync["kf_ms"],
         frames_tracked_in_flight=slam.metrics["frames_tracked_in_flight"],
         staleness=staleness, staleness_max=max(staleness, default=0),
         tracking_iters_mean=out["tracking_iters_mean"], init_s=stages["init"]["total_s"])
    line("async", ckpt_saves=stages.get("ckpt.save", {}).get("n", 0),
         ckpt_write_ms=stages.get("ckpt.save", {}).get("mean_ms"), ckpt_bytes=ckpt_bytes,
         peak_mem_gib=c["peak_mem_gib"], sync_peak_mem_gib=sync["peak_mem_gib"])
    # Launches by stream: the tracker's (and the ground truth's) on the
    # default stream, the mapper's on its own; a backward launches from
    # autograd's device thread on its forward's stream.
    streams = {"default": "tracker", kernels.stream_key(slam.mapper_stream): "mapper"}
    for name, by_stream in c["launches_by_stream"].items():
        line("launches", path="async", kernel=name,
             **{streams.get(k, k): v for k, v in by_stream.items()})
    line("async", host_reads_by_thread=repr(c["reads_by_thread"]))
    for k, v in sorted(stages.items()):
        print(f"  stage: {k:18s} n={v['n']:3d} total_s={v['total_s']:.3f} "
              f"mean_ms={v['mean_ms']:.2f}")
    require(metrics["mode"] == "async", f"metrics.json says mode {metrics['mode']!r}")
    require(out["final_ate_rmse"] < SYSTEM_ATE_MAX,
            f"async ATE {out['final_ate_rmse']:.4f} m is not under {SYSTEM_ATE_MAX}")
    require(ev["mean_psnr"] > SYSTEM_PSNR_MIN,
            f"async PSNR {ev['mean_psnr']:.2f} dB is not over {SYSTEM_PSNR_MIN}")
    for name in ("slab_fwd", "slab_bwd", "rows_to_channels"):
        by = c["launches_by_stream"][name]
        require(all(by.get(k, 0) > 0 for k in streams),
                f"{name} did not launch on both the tracker's and the mapper's stream: {by}")
    require(stages.get("ckpt.save", {}).get("n") == 1 and ckpt_bytes > 0,
            "the async run did not checkpoint once")

    # 11b. The cold resume.
    res = _slam_of(ASYNC_ARGV[1])
    require(res.state is None, "11b: the fresh SLAM has a state")
    load_checkpoint(ckpt_dir, res)
    start = max(res.est_poses) + 1
    t0 = time.perf_counter()
    ate = res.run_async(n_frames=16, start_frame=start)
    resume_s = time.perf_counter() - t0
    active = int(res.state.gmap.num_active)
    line("resume", checkpoint_frames=start, resumed_frames=len(res.est_poses) - start, ate_rmse=ate,
         active=active, frames=sorted(res.est_poses) == list(range(16)), s=f"{resume_s:.1f}")
    require(sorted(res.est_poses) == list(range(16)),
            f"11b: the stitched trajectory covers {sorted(res.est_poses)}")
    require(ate < SYSTEM_ATE_MAX and active > 100,
            f"11b: resumed ATE {ate:.4f} m, {active} active Gaussians")
    del res

    # 11c. --resume-run regenerates metrics.json.
    os.remove(os.path.join(out["save_dir"], "metrics.json"))
    shutil.rmtree(os.path.join(out["save_dir"], "psnr"))
    again, c2 = drive_cli(["--resume-run", out["save_dir"], *RESUME_RUN_ARGV])
    same = {"ate": abs(again["final_ate_rmse"] - metrics["final_ate_rmse"]) <= 1e-9,
            "psnr": abs(again["psnr"] - metrics["psnr"]) <= 1e-4,
            "ssim": abs(again["ssim"] - metrics["ssim"]) <= 1e-5,
            "n_frames": again["n_frames"] == metrics["n_frames"],
            "fps": again["fps"] == metrics["fps"]}
    line("resume_run", **same, slab_bwd=c2["launches"]["slab_bwd"],
         slab_fwd=c2["launches"]["slab_fwd"], phase_s=f"{c2['phase_s']:.1f}")
    require(all(same.values()), f"11c: --resume-run regenerated other figures: {same}")
    require(c2["launches"]["slab_bwd"] == 0, "11c: --resume-run ran the frame loop")
    del again, out, slam

    # 11d. Bootstrap equivalence.
    ref = _slam_of(EQUIV_CONFIG)
    ref.run()
    boot = _slam_of(EQUIV_CONFIG, async_bootstrap_kfs=99)
    kernels.reset_launches()
    boot.run_async()
    err = max(float(np.abs(np.asarray(a) - np.asarray(b)).max())
              for i in ref.est_poses for a, b in zip(boot.est_poses[i], ref.est_poses[i]))
    act = (int(boot.state.gmap.num_active), int(ref.state.gmap.num_active))
    mapper_bwd = kernels.slab_bwd.by_stream.get(kernels.stream_key(boot.mapper_stream), 0)
    line("equivalence", config=EQUIV_CONFIG, frames=len(ref.est_poses), pose_max_abs_err=err,
         active=act, same_keyframes=boot.kf_history == ref.kf_history,
         mapper_slab_bwd=mapper_bwd)
    require(sorted(boot.est_poses) == sorted(ref.est_poses) and err <= EQUIV_POSE_TOL
            and act[0] == act[1] and boot.kf_history == ref.kf_history,
            f"11d: run_async with the bootstrap window differs from run(): pose error "
            f"{err}, active {act}")
    require(mapper_bwd > 0, "11d: the mapper's stream launched no slab_bwd")
    return c["launches"]


# Phase 12: the TUM RGB-D on-disk layout on the card. 16 frames of
# room_final.yaml's room (the GT rendered through slab_fwd) are written in
# TUM's layout by the port's fixture tool and PNG writer, read back by the
# TUM parser (stamped tables, association, 32 Hz thinning, c2w quaternion
# poses, 16-bit depth / 5000, the port's PNG decoder), and run through the
# command line on configs/rgbd/tum/room_fixture.yaml (inherited, its
# dataset_path set to the fixture: the command line has no such flag).
# Then the parsers that need OpenCV must say so on a machine without it.
TUM_SOURCE, TUM_CONFIG, TUM_FRAMES = ("configs/synthetic/room_final.yaml",
                                      "configs/rgbd/tum/room_fixture.yaml", 16)
TUM_DIR = os.path.join("build", "tum_fixture_smoke")
TUM_POSE_TOL = 1e-5


def _tiny_opencv_fixtures(root: str, cv2=None) -> dict:
    """One-frame Replica, DAVIS, Kubric and EuRoC layouts under root, and
    room_stereo.yaml's rig. PNGs go through write_png; the .jpg and .tiff
    files through `cv2` where it is given, else they are empty files (only
    their paths are read before OpenCV would decode them). -> {name:
    config}."""
    import numpy as np
    from monogs_torch.utils.config import load_config
    from monogs_torch.utils.images import write_png

    h, w = 48, 64
    calib = {"fx": 50.0, "fy": 50.0, "cx": 32.0, "cy": 24.0, "width": w, "height": h,
             "depth_scale": 1000.0}

    def put(rel, img):
        path = os.path.join(root, rel)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        if isinstance(img, str):
            with open(path, "w") as f:
                f.write(img)
        elif path.endswith(".png"):
            write_png(path, img)
        elif cv2 is not None:
            require(cv2.imwrite(path, img), f"12d: OpenCV did not write {path}")
        else:
            open(path, "wb").close()

    depth = np.full((h, w), 2000, np.uint16)
    gray = (np.arange(h * w, dtype=np.uint32).reshape(h, w) % 251).astype(np.uint8)
    color = np.dstack([gray, 255 - gray, gray // 2])
    put("replica/results/frame000000.jpg", color)
    put("replica/results/depth000000.png", depth)
    put("replica/traj.txt", (" ".join(str(v) for v in np.eye(4).ravel()) + "\n") * 2)
    put("davis/rgb/00000.jpg", color)
    put("davis/segmentation/00000.png", np.zeros((h, w), np.uint8))
    put("kubric/rgba/rgba_00000.png", np.dstack([gray] * 4))
    put("kubric/depth/depth_00000.tiff", np.full((h, w), 2.0, np.float32))
    put("kubric/segmentation/segmentation_00000.png", np.zeros((h, w), np.uint8))
    put("kubric/metadata.json", json.dumps({"camera": {"positions": [[0.0, 0.0, 0.0]],
                                                       "quaternions": [[1.0, 0, 0, 0]]}}))
    # EuRoC's SGBM (64 disparities, block 20) needs a wider image: a
    # random texture, the right view 8 px to the left.
    eh, ew = 96, 192
    tex = np.random.RandomState(7).randint(0, 256, (eh, ew + 8)).astype(np.uint8)
    put("euroc/mav0/cam0/data/1000000.png", tex[:, :-8])
    put("euroc/mav0/cam1/data/1000000.png", tex[:, 8:])
    put("euroc/mav0/state_groundtruth_estimate0/data.csv",
        "#timestamp,p,q\n1000000,0,0,0,1,0,0,0\n")
    cam = {"fx": 80.0, "fy": 80.0, "cx": ew / 2, "cy": eh / 2}
    raw = dict(cam, k1=0.0, k2=0.0, p1=0.0, p2=0.0, k3=0.0)
    eye = {"data": [1.0, 0, 0, 0, 1.0, 0, 0, 0, 1.0]}

    def ds(typ, c=calib):
        return {"Dataset": {"type": typ, "dataset_path": os.path.join(root, typ),
                            "Calibration": c}}
    return {
        "replica": ds("replica"), "davis": ds("davis"), "kubric": ds("kubric"),
        "euroc": ds("euroc", {"width": ew, "height": eh, "depth_scale": 1.0,
                              "cam0": {"raw": raw, "opt": dict(cam), "R": eye},
                              "cam1": {"raw": raw, "opt": dict(cam), "R": eye}}),
        "stereo_rig": load_config("configs/synthetic/room_stereo.yaml"),
    }


def tum_phase(smi: str, sync: dict) -> dict:
    """Phase 12, the TUM layout on the card.
    12a: write_tum_fixture on 16 frames of room_final.yaml's room (GT through
    slab_fwd, encodes through write_png): bytes, encode ms a frame, the rows
    of each PNG filter type. 12b: the TUM parser on it: the association
    keeps all 16 rgb frames, each frame the 32 Hz thinning keeps decodes to
    the synthetic frame quantised as the writer quantised it (uint8 rgb /
    255, uint16 depth / 5000, float32) bit for bit, each w2c pose within
    1e-5 of the synthetic one; decode ms a frame. 12c: main() on a config
    inheriting room_fixture.yaml with its dataset_path set to 12a's
    directory, --eval: check_run's checks (no GT render: the frames are
    files), ATE < 0.05 m, PSNR > 15 dB; fps, wall, ATE, PSNR, SSIM, active,
    tracking ms a frame beside phase 9's and the frame.load stage's ms a
    frame. 12d: what the machine offers (cv2, PIL, libnvjpeg); without cv2
    building the Replica, DAVIS, Kubric and EuRoC parsers and
    room_stereo.yaml's rig must raise ImportError naming OpenCV; with cv2
    each must build and read its first frame (the rig's two renders through
    slab_fwd, its SGBM depth valid on over a quarter of the pixels and
    within 8% median of the rendered depth). -> 12c's launches of each
    kernel."""
    import glob
    import importlib.util

    import numpy as np
    import torch
    from monogs_torch.data import load_dataset
    from monogs_torch.data.tum import TUMDataset, match_streams, read_stamped_table
    from monogs_torch.ops import kernels
    from monogs_torch.tools.make_tum_fixture import quantise, write_tum_fixture
    from monogs_torch.utils.config import load_config

    # 12a. The fixture.
    os.environ["MONOGS_SYNTH_CACHE"] = "0"
    shutil.rmtree(TUM_DIR, ignore_errors=True)
    src = load_dataset(load_config(TUM_SOURCE), device="cuda")
    kernels.reset_launches()
    stats = write_tum_fixture(src, TUM_DIR, TUM_FRAMES)
    gt_fwd = kernels.slab_fwd.launches
    n = stats["frames"]
    line("tum", step="12a", source=TUM_SOURCE, frames=n, bytes=stats["bytes"],
         encode_ms_per_frame=stats["encode_s"] * 1e3 / n,
         render_ms_per_frame=stats["render_s"] * 1e3 / n, gt_slab_fwd=gt_fwd,
         **{f"rows_{k}": v for k, v in stats["filters"].items()}, card=repr(smi))
    require(n == TUM_FRAMES and gt_fwd >= TUM_FRAMES,
            f"12a: {n} frames written, {gt_fwd} slab_fwd launches for their GT")

    # 12b. The parser.
    cfg = load_config(TUM_CONFIG)
    cfg["Dataset"]["dataset_path"] = TUM_DIR
    tabs = [read_stamped_table(os.path.join(TUM_DIR, f)) for f in ("rgb.txt", "depth.txt")]
    tabs.append(read_stamped_table(os.path.join(TUM_DIR, "groundtruth.txt"), skiprows=1))
    associated = len(match_streams(*(t[:, 0].astype(np.float64) for t in tabs))[0])
    tum = TUMDataset(cfg)
    names = [os.path.join(TUM_DIR, p) for p in tabs[0][:, 1]]
    decode_s, exact, pose_err = 0.0, True, 0.0
    for k in range(len(tum)):
        i = names.index(tum.color_paths[k])
        tic = time.perf_counter()
        f = tum[k]
        decode_s += time.perf_counter() - tic
        g = src[i]
        rgb8, dep16 = quantise(g)
        exact &= bool(np.array_equal(f["rgb"], (rgb8 / 255.0).astype(np.float32))
                      and np.array_equal(f["depth"], dep16.astype(np.float32) / 5000.0))
        pose_err = max(pose_err, float(np.abs(f["pose"] - g["pose"]).max()))
    decode_ms = decode_s * 1e3 / len(tum)
    line("tum", step="12b", associated=associated, thinned=len(tum),
         frames_bit_exact=exact, pose_max_abs_err=pose_err,
         decode_ms_per_frame=decode_ms, note="decode = rgb + depth PNG and the float32 "
         "conversion, on the host")
    require(associated == TUM_FRAMES, f"12b: the association kept {associated} of "
            f"{TUM_FRAMES} rgb frames")
    require(exact, "12b: a decoded TUM frame differs from the quantised synthetic frame")
    require(pose_err <= TUM_POSE_TOL, f"12b: a TUM pose is {pose_err} from the synthetic one")
    del src, tum

    # 12c. The system through the command line.
    run_cfg = os.path.join("build", "tum_fixture_smoke.yaml")
    with open(run_cfg, "w") as fh:
        json.dump({"inherit_from": TUM_CONFIG, "Dataset": {"dataset_path": TUM_DIR}}, fh)
    out, c = drive_cli(["--config", run_cfg, "--eval", "--device", "cuda", "--backend", "slab"])
    slam, stages = out["slam"], out["stages"]
    figures = check_run(out, c, smi, "tum", synthetic=False)
    with open(os.path.join(out["save_dir"], "psnr", "final", "final_result.json")) as fh:
        ev = json.load(fh)
    track_ms = sum(stages[k]["total_s"] for k in ("track.dispatch", "track.readback")) \
        / figures["n_tracked"] * 1e3
    load_ms = stages["frame.load"]["total_s"] * 1e3 / stages["frame.load"]["n"]
    line("tum", step="12c", config=TUM_CONFIG, dataset=type(slam.dataset).__name__,
         frames=out["n_frames"], fps=out["fps"], wall_s=out["wall_s"],
         phase_s=f"{c['phase_s']:.1f}", host_cpu=repr(host_cpu()), card=repr(smi))
    line("tum", ate_rmse=out["final_ate_rmse"], psnr=ev["mean_psnr"], ssim=ev["mean_ssim"],
         eval_frames=ev["n_frames"], active=out["map_active"], keyframes=out["n_keyframes"],
         kf_history=sorted(slam.kf_history))
    line("tum", tracking_ms_per_frame=track_ms, sync_tracking_ms_per_frame=sync["track_ms"],
         frame_load_ms_per_frame=load_ms, decode_ms_per_frame=decode_ms,
         tracking_iters_mean=out["tracking_iters_mean"], init_s=stages["init"]["total_s"])
    for k, v in sorted(stages.items()):
        print(f"  stage: {k:18s} n={v['n']:3d} total_s={v['total_s']:.3f} "
              f"mean_ms={v['mean_ms']:.2f}")
    require(type(slam.dataset).__name__ == "TUMDataset", "12c did not read the TUM layout")
    require(out["final_ate_rmse"] < SYSTEM_ATE_MAX,
            f"TUM ATE {out['final_ate_rmse']:.4f} m is not under {SYSTEM_ATE_MAX}")
    require(ev["mean_psnr"] > SYSTEM_PSNR_MIN,
            f"TUM PSNR {ev['mean_psnr']:.2f} dB is not over {SYSTEM_PSNR_MIN}")
    launches = dict(c["launches"])
    del out, slam

    # 12d. Honest errors where OpenCV is missing.
    have = {m: importlib.util.find_spec(m) is not None for m in ("cv2", "PIL")}
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    nvjpeg = sorted({os.path.basename(p) for p in glob.glob(os.path.join(
        cuda_home, "**", "libnvjpeg*"), recursive=True)})
    torch_nvjpeg = sorted({os.path.basename(p) for p in glob.glob(os.path.join(
        os.path.dirname(torch.__file__), "..", "nvidia", "**", "libnvjpeg*"), recursive=True)})
    line("tum", step="12d", cv2=have["cv2"], PIL=have["PIL"], cuda_home=cuda_home,
         toolkit_libnvjpeg="+".join(nvjpeg) or "none",
         python_libnvjpeg="+".join(torch_nvjpeg) or "none")
    cv2 = importlib.import_module("cv2") if have["cv2"] else None
    if cv2 is not None:
        line("tum", step="12d", cv2_version=cv2.__version__)
    fixtures = _tiny_opencv_fixtures(os.path.join("build", "tum_smoke_cv2"), cv2)
    for name, dcfg in fixtures.items():
        try:
            ds, err = load_dataset(dcfg, device="cuda"), None
        except ImportError as e:
            ds, err = None, str(e)
        if cv2 is None:
            line("tum", step="12d", dataset=name, built=err is None, error=repr(err))
            require(err is not None and "OpenCV" in err,
                    f"12d: {name} built, or raised without naming OpenCV, on a machine "
                    "without cv2")
            continue
        # OpenCV is here: the parser must build and read its first frame.
        require(err is None, f"12d: {name} did not build with OpenCV present: {err}")
        fwd0 = kernels.slab_fwd.launches
        tic = time.perf_counter()
        f = ds[0]
        read_ms = (time.perf_counter() - tic) * 1e3
        depth = f["depth"]
        ok = (f["rgb"].shape == (ds.height, ds.width, 3) and bool(np.isfinite(f["rgb"]).all())
              and (depth is None or (depth.shape == (ds.height, ds.width)
                                     and bool(np.isfinite(depth).all()))))
        extra = {}
        if name == "stereo_rig":
            # The JAX suite's bounds on the rig (tests/test_datasets.py:423-434):
            # SGBM matches over a quarter of the pixels, its depth within 8%
            # (median) of the rendered depth where both are valid.
            gt = ds._render_pose(ds.poses[0])["depth"]
            valid = depth > 0
            both = valid & (gt > 0)
            rel = float(np.median(np.abs(depth[both] - gt[both]) / gt[both]))
            extra = {"valid_share": float(valid.mean()), "median_rel_err": rel,
                     "slab_fwd": kernels.slab_fwd.launches - fwd0}
            ok = ok and valid.mean() > 0.25 and rel < 0.08 and extra["slab_fwd"] >= 3
        line("tum", step="12d", dataset=name, built=True, frame_ok=ok,
             read_ms=f"{read_ms:.1f}", **extra)
        require(ok, f"12d: {name}'s first frame is wrong with OpenCV present: {extra}")
    return launches


# Phase 13: the live web viewer on the SLAM of room.yaml at its full width
# (640x480, the 150,000-Gaussian room, the config's budgets): 6 frames
# synchronous (keyframes 0 and 5: the map initialisation and one mapping
# event), then frames 6-10 concurrent (run_async from frame 6, keyframe 10's
# event in flight) with the same requests made meanwhile; cut from 200
# frames. The default view is 480x360 at render's tile 16 (22.5 tile rows:
# the last row lies half outside the image).
VIEWER_SYNC_FRAMES, VIEWER_FRAMES = 6, 11
VIEWER_SHADERS = ("rgb", "depth", "segmentation", "time", "ellipsoids")
VIEWER_DIR = os.path.join("build", "viewer_smoke")
# The full (640x480) view's binning overflows at tile 16 (max_dup), and a
# float32 rounding apart between the card's projection and the CPU's can
# move an entry across the cap: 1 pixel of 307,200 was off in each chip run.
# The view is held against the twin on the card at 1e-5, and to at most
# this many pixels past 1e-5 from the CPU twin.
VIEWER_FULL_PIXELS_OFF = 8


def _fetch(url: str) -> tuple:
    """GET url -> (status, content type, body, ms from request to bytes)."""
    import urllib.error
    import urllib.request

    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(url, timeout=120) as r:
            body = r.read()
            return r.status, r.headers.get("Content-Type"), body, \
                (time.perf_counter() - t0) * 1e3
    except urllib.error.HTTPError as e:
        return e.code, None, b"", (time.perf_counter() - t0) * 1e3


def _viewer_requests(kf: int) -> list:
    return (["/", "/state"] + [f"/render?follow=1&shader={s}" for s in VIEWER_SHADERS]
            + [f"/render?kf={kf}&shader=rgb", "/screenshot?follow=1&shader=rgb", "/input"])


def _on_cpu(x):
    """A (nested NamedTuple / dict) state's tensors copied to the CPU."""
    import torch

    if torch.is_tensor(x):
        return x.cpu()
    if isinstance(x, dict):
        return {k: _on_cpu(v) for k, v in x.items()}
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(_on_cpu(v) for v in x))
    return x


def viewer_phase(smi: str) -> dict:
    """Phase 13, the live web viewer on the card. A room.yaml SLAM with
    start_viewer on a free port runs 6 frames; then /, /state, /render in
    each shader at the default 480x360 view, a kf= view, /screenshot
    (640x480) and /input, each answered 200 with an image of its size; each
    shader's render_fn output held against the same view from the CPU twin
    on a copy of the state (rgb-like 1e-5, the depth shader 1e-4; the full
    view too), and each /render PNG's pixels (frusta off) within one level
    of the twin's. Then frames 6-10 under run_async while a client thread
    repeats the same requests: every answer 200, the run's ATE < 0.05 m
    and PSNR > 15 dB (phase 9's gates). ms per /render (request to bytes)
    idle and during the run; launches per stream, the viewer's apart.
    -> each kernel's launches in the phase (the twin checks apart)."""
    import threading
    import types

    import numpy as np
    import torch
    from monogs_torch.ops import kernels
    from monogs_torch.utils.images import decode_png, read_png
    from monogs_torch.viewer.server import make_render_fn

    shutil.rmtree(VIEWER_DIR, ignore_errors=True)
    slam = _slam_of(SYSTEM_ARGV[1])
    slam.scfg.save_dir = VIEWER_DIR
    viewer = slam.start_viewer(port=0)
    base = f"http://127.0.0.1:{viewer.port}"
    counted = (kernels.slab_fwd, kernels.slab_bwd, kernels.rows_to_channels,
               kernels.tile_order)
    try:
        kernels.reset_launches()
        t0 = time.perf_counter()
        slam.run(n_frames=VIEWER_SYNC_FRAMES)
        sync_s = time.perf_counter() - t0
        kf = sorted(slam.kf_list)[0]
        W, H = slam.intr.width, slam.intr.height
        scale = min(1.0, 480 / W)
        view = (int(H * scale), int(W * scale), 3)
        idle = {}
        for path in _viewer_requests(kf):
            status, ctype, body, ms = _fetch(base + path)
            idle[path] = (status, ms)
            require(status == 200, f"13: {path} answered {status}")
            if path.startswith("/render"):
                require(decode_png(body).shape == view, f"13: {path} is not a {view} PNG")
            elif path.startswith("/screenshot"):
                shot = read_png(json.loads(body)["path"])
                require(shot.shape == (H, W, 3), "13: the screenshot is not full size")
            elif path == "/input":
                require(decode_png(body).shape == (H, 3 * W, 3), "13: /input's strip")
        render_ms = [ms for p, (_, ms) in idle.items() if p.startswith("/render")]
        line("viewer", step="13a", frames=VIEWER_SYNC_FRAMES, run_s=f"{sync_s:.1f}",
             port=viewer.port, requests=len(idle), all_200=True,
             render_ms_median=statistics.median(render_ms), render_ms_max=max(render_ms),
             screenshot_ms=idle["/screenshot?follow=1&shader=rgb"][1],
             input_ms=idle["/input"][1], card=repr(smi))

        # The same requests during a concurrent run.
        answers, stop = [], threading.Event()

        def client():
            while not stop.is_set():
                for path in _viewer_requests(kf):
                    answers.append((path, *_fetch(base + path)[::3]))

        client_t = threading.Thread(target=client, name="viewer-client", daemon=True)
        client_t.start()
        t0 = time.perf_counter()
        try:
            ate = slam.run_async(n_frames=VIEWER_FRAMES, start_frame=VIEWER_SYNC_FRAMES)
        finally:
            stop.set()
            client_t.join(timeout=300)
        async_s = time.perf_counter() - t0
        require(not client_t.is_alive(), "13: the viewer client did not stop")
        launches = {k.__name__: k.launches for k in kernels.LAUNCHERS}
        by_stream = {k.__name__: dict(k.by_stream) for k in counted}
        ev = slam.eval_rendering(every=5, label="viewer")
        bad = [(p, st) for p, st, _ in answers if st != 200]
        busy_ms = [ms for p, st, ms in answers if p.startswith("/render")]
        line("viewer", step="13b", frames=f"{VIEWER_SYNC_FRAMES}-{VIEWER_FRAMES - 1}",
             run_s=f"{async_s:.1f}", requests=len(answers), not_200=len(bad),
             render_ms_median=statistics.median(busy_ms) if busy_ms else None,
             render_ms_max=max(busy_ms, default=None), ate_rmse=ate, psnr=ev["mean_psnr"],
             ssim=ev["mean_ssim"], active=int(slam.state.gmap.num_active),
             kf_history=sorted(slam.kf_history), card=repr(smi))
        streams = {"default": "tracker", kernels.stream_key(slam.mapper_stream): "mapper",
                   kernels.stream_key(viewer._render_fn.stream): "viewer"}
        for name, by in by_stream.items():
            line("launches", path="viewer", kernel=name,
                 **{streams.get(k, k): v for k, v in by.items()})
        require(not bad and len(answers) >= len(_viewer_requests(kf)),
                f"13: requests during run_async: {len(answers)} made, not 200: {bad[:5]}")
        require(ate < SYSTEM_ATE_MAX, f"13: ATE {ate:.4f} m is not under {SYSTEM_ATE_MAX}")
        require(ev["mean_psnr"] > SYSTEM_PSNR_MIN,
                f"13: PSNR {ev['mean_psnr']:.2f} dB is not over {SYSTEM_PSNR_MIN}")
        viewer_fwd = by_stream["slab_fwd"].get(kernels.stream_key(viewer._render_fn.stream), 0)
        require(viewer_fwd >= len(render_ms) + len(busy_ms),
                f"13: slab_fwd launched {viewer_fwd} times on the viewer's stream for "
                f"{len(render_ms) + len(busy_ms)} renders")

        # The card's render_fn against the twins: the CPU twin on a copy of
        # the state, and the twin on the card (the same projection and bins,
        # the slab dispatcher sent to the plain forward); the served PNGs
        # against the CPU twin's quantised image. The full view: see
        # VIEWER_FULL_PIXELS_OFF.
        from monogs_torch.ops import tile_raster

        def card_twin(*a, **kw):
            saved = tile_raster._fwd_slab
            tile_raster._fwd_slab = (lambda f, p, c, order, cfg, K, emit=True:
                                     tile_raster._fwd_slab_plain(f, p, c, cfg, K, emit))
            try:
                return viewer._render_fn(*a, **kw)[0]
            finally:
                tile_raster._fwd_slab = saved

        st_cpu = _on_cpu(slam.read_state())
        twin = make_render_fn(types.SimpleNamespace(
            device=torch.device("cpu"), intr=slam.intr, mcfg=slam.mcfg,
            read_state=lambda: st_cpu))
        pkt = viewer.slot.get()
        views = [(s, "follow", pkt.cur_pose, False) for s in VIEWER_SHADERS]
        kf_last = sorted(pkt.kf_poses)[0]
        views += [("rgb", f"kf{kf_last}", pkt.kf_poses[kf_last], False),
                  ("rgb", "follow", pkt.cur_pose, True)]
        for shader, where, (R, t), full in views:
            tic = time.perf_counter()
            card, _ = viewer._render_fn(R, t, shader, full=full)
            card_ms = (time.perf_counter() - tic) * 1e3
            tic = time.perf_counter()
            plain, _ = twin(R, t, shader, full=full)
            plain_ms = (time.perf_counter() - tic) * 1e3
            on_card = card_twin(R, t, shader, full=full)
            err = float(np.abs(card - plain).max())
            err_card = float(np.abs(card - on_card).max())
            tol = 1e-4 if shader == "depth" else 1e-5
            png_err = None
            if where == "follow" and not full:
                body = _fetch(f"{base}/render?follow=1&frusta=0&shader={shader}")[2]
                q = (np.clip(plain, 0, 1) * 255).astype(np.uint8).astype(np.int16)
                png_err = int(np.abs(decode_png(body).astype(np.int16) - q).max())
            off = int((np.abs(card - plain) > tol).any(-1).sum())
            line("viewer", step="13c", shader=shader, view=where, shape=card.shape,
                 max_abs_err_cpu_twin=err, max_abs_err_card_twin=err_card,
                 twins_apart=float(np.abs(on_card - plain).max()),
                 pixels_off_cpu_twin=off, tol=tol, png_levels=png_err,
                 card_ms=f"{card_ms:.2f}", plain_cpu_ms=f"{plain_ms:.1f}")
            require(err_card <= tol
                    and (off <= VIEWER_FULL_PIXELS_OFF if full else err <= tol)
                    and (png_err is None or png_err <= 1),
                    f"13: the {shader} view ({where}, full={full}) is off its twins: "
                    f"CPU {err} ({off} pixels past {tol}), card {err_card}, "
                    f"PNG {png_err} levels")
    finally:
        viewer.stop()
    return launches


# Phase 14: the sharded mapper at world size 1 (NCCL refuses two ranks on
# one card): a real NCCL group, the sharded iteration's reduce-scatter and
# all-gather on the card, held against the unsharded iteration on phase 6's
# state (bench_mapping's widths); then the command line on room.yaml with
# mesh_devices 1 for 6 frames (keyframes 0 and 5), its group of one made by
# the SLAM itself.
SHARD_FRAMES = 6
SHARD_CONFIG = os.path.join("build", "room_mesh1_smoke.yaml")
SHARD_ARGV = ["--config", SHARD_CONFIG, "--n-frames", str(SHARD_FRAMES), "--eval",
              "--device", "cuda", "--backend", "slab"]


def sharded_phase(smi: str) -> dict:
    """Phase 14, the window-sharded mapper on the card.
    14a, on a world-size-1 NCCL group: one sharded mapping iteration on
    phase 6's state against the unsharded one (expected bit-identical; the
    gate is the CPU suite's: loss 1e-5 relative, first moments at the
    gradient floor, xyz and the statistics 1e-5, the window 1e-6), the
    unsharded iteration against itself (the card's run-to-run determinism),
    one reduce-scatter of the packed gradients an iteration, ms per
    iteration of both (spans of 8 alternated, median of 4) and their
    device busy time under the profiler; one sharded iteration's launches
    on a line of their own.
    14b: main() on room.yaml with mesh_devices 1 for 6 frames, the counts
    set to 0 just before: check_run's checks, every mapping iteration the
    sharded one (none unsharded), ATE < 0.05 m, PSNR > 15 dB.
    -> each kernel's launches in 14b."""
    import torch
    import torch.distributed as dist
    from monogs_torch.ops import kernels
    from monogs_torch.parallel import overlap
    from monogs_torch.parallel.mesh import make_mesh
    from monogs_torch.slam import mapper as tm
    from monogs_torch.utils.ckpt import state_tensors

    dev = torch.device("cuda")
    state, intr, cfg = build_mapping_state(dev)
    span_cfg = dataclasses.replace(cfg, converged_eps=0.0)
    mesh = make_mesh(1, "cuda")
    try:
        def one(m=None):
            out = tm.mapping_span(state, intr, span_cfg, False, 0, 1, mesh=m)
            torch.cuda.synchronize()
            return out

        def span_ms(m=None):
            tic = time.perf_counter()
            tm.mapping_span(state, intr, span_cfg, False, 0, cfg.rebin_every, mesh=m)
            torch.cuda.synchronize()
            return (time.perf_counter() - tic) / cfg.rebin_every * 1e3

        def diff(a, b):
            ta, tb = state_tensors(a[0]), state_tensors(b[0])
            errs = {k: float((ta[k].double() - tb[k].double()).abs().max())
                    for k in ta if ta[k].is_floating_point()}
            same = all(torch.equal(ta[k], tb[k]) for k in ta) and torch.equal(
                a[1].loss, b[1].loss) and torch.equal(a[1].vis_filter, b[1].vis_filter)
            return same, errs

        def busy(m=None):
            prof = device_profile(lambda: tm.mapping_span(
                state, intr, span_cfg, False, 0, cfg.rebin_every, mesh=m), cfg.rebin_every)
            return None if prof is None else (prof["device_busy_ms_per_iter"],
                                              prof["wall_ms_per_iter"])

        ref, ref2 = one(), one()
        calls = {"reduce_scatter_tensor": 0, "all_gather_into_tensor": 0, "all_reduce": 0}
        saved = {n: getattr(dist, n) for n in calls}

        def counting(name):
            def call(*a, **kw):
                calls[name] += 1
                return saved[name](*a, **kw)
            return call

        kernels.reset_launches()
        for n in calls:
            setattr(dist, n, counting(n))
        try:
            got = one(mesh)
        finally:
            for n, fn in saved.items():
                setattr(dist, n, fn)
        per_span = dict(calls)
        line("launches", path="sharded_iteration", note="14a: one span of 1",
             **{k.__name__: k.launches for k in kernels.LAUNCHERS})
        # The host's speed drifts within a call: the two alternate, spans of
        # 8, median of 4 each.
        times = {"plain": [], "shard": []}
        for _ in range(4):
            times["plain"].append(span_ms())
            times["shard"].append(span_ms(mesh))
        plain_ms, shard_ms = (statistics.median(times[k]) for k in ("plain", "shard"))
        plain_busy, shard_busy = busy(), busy(mesh)
        same, errs = diff(got, ref)
        det, _ = diff(ref2, ref)
        (s2, a2), (s1, a1) = got, ref
        loss_rel = abs(float(a2.loss) - float(a1.loss)) / max(abs(float(a1.loss)), 1e-12)
        mu_ok = all(bool(((s2.adam.mu[k] - m1).abs()
                          <= 2e-3 * m1.abs() + 1e-6 + 1e-4 * m1.abs().reshape(
                              m1.shape[0], -1).amax(0).reshape((1,) + m1.shape[1:])).all())
                    for k, m1 in s1.adam.mu.items())
        close = (loss_rel <= 1e-5 and mu_ok
                 and max(errs[k] for k in errs if k.startswith("gmap.params.xyz")
                         or k in ("gmap.xyz_grad_accum", "gmap.max_radii2d")) <= 1e-5
                 and max(errs[k] for k in errs if k.startswith("window.frames.")) <= 1e-6)
        line("sharded", step="14a", backend=dist.get_backend(), world=dist.get_world_size(),
             capacity=M_CAP, live=M_LIVE, window=WIN, bit_identical=same,
             unsharded_deterministic=det, loss_rel_err=loss_rel,
             max_err_params=max(v for k, v in errs.items() if k.startswith("gmap.params")),
             max_err_moments=max(v for k, v in errs.items() if k.startswith("adam.")),
             max_err_window=max(v for k, v in errs.items() if k.startswith("window.")),
             collectives_span_of_1=repr(per_span), card=repr(smi))
        line("sharded", step="14a", sharded_ms_per_iter=shard_ms,
             unsharded_ms_per_iter=plain_ms, iters_per_span=cfg.rebin_every, spans=4,
             sharded_all=repr(times["shard"]), unsharded_all=repr(times["plain"]),
             card=repr(smi))
        line("profile", path="sharded", iters=cfg.rebin_every,
             device_busy_ms_per_iter=shard_busy and shard_busy[0],
             wall_ms_per_iter=shard_busy and shard_busy[1],
             unsharded_device_busy_ms_per_iter=plain_busy and plain_busy[0],
             unsharded_wall_ms_per_iter=plain_busy and plain_busy[1], card=repr(smi))
        require(dist.get_backend() == "nccl", "14a: the group is not NCCL")
        # A span of one iteration: the packed gradients' reduce-scatter and
        # the parameters' all-gather, then the span end's gathers.
        require(per_span["reduce_scatter_tensor"] == 1
                and per_span["all_gather_into_tensor"] >= 1,
                f"14a: the sharded iteration's collectives: {per_span}")
        require(close, f"14a: the sharded iteration is off the unsharded one: loss "
                       f"{loss_rel:.3e}, moments within the floor {mu_ok}, {errs}")
        del state, ref, ref2, got, s1, s2
    finally:
        dist.destroy_process_group()

    # 14b. The command line with mesh_devices 1 and no group: the SLAM makes
    # its own (NCCL, one rank).
    with open(SHARD_CONFIG, "w") as fh:
        json.dump({"inherit_from": SYSTEM_ARGV[1], "System": {"mesh_devices": 1}}, fh)
    iters = {"sharded": 0, "unsharded": 0}
    saved_iter = (overlap.sharded_mapping_iter, tm._mapping_iter)

    def counted(kind, fn):
        def call(*a, **kw):
            iters[kind] += 1
            return fn(*a, **kw)
        return call

    overlap.sharded_mapping_iter = counted("sharded", saved_iter[0])
    tm._mapping_iter = counted("unsharded", saved_iter[1])
    try:
        out, c = drive_cli(SHARD_ARGV)
        backend = dist.get_backend() if dist.is_initialized() else None
        world = dist.get_world_size() if dist.is_initialized() else None
    finally:
        overlap.sharded_mapping_iter, tm._mapping_iter = saved_iter
        if dist.is_initialized():
            dist.destroy_process_group()
    slam = out["slam"]
    check_run(out, c, smi, "sharded")
    with open(os.path.join(out["save_dir"], "psnr", "final", "final_result.json")) as fh:
        ev = json.load(fh)
    line("sharded", step="14b", config=SYSTEM_ARGV[1], mesh_devices=1, backend=backend,
         world=world, frames=out["n_frames"], fps=out["fps"], wall_s=out["wall_s"],
         ate_rmse=out["final_ate_rmse"], psnr=ev["mean_psnr"], ssim=ev["mean_ssim"],
         active=out["map_active"], window_capacity=slam._window_capacity(),
         sharded_iters=iters["sharded"], unsharded_iters=iters["unsharded"], card=repr(smi))
    require(slam.mesh is not None and slam.mesh.size == 1 and backend == "nccl",
            f"14b: the SLAM's mesh {slam.mesh}, its group {backend}")
    require(iters["sharded"] > 0 and iters["unsharded"] == 0,
            f"14b: mapping iterations sharded / unsharded: {iters}")
    require(out["final_ate_rmse"] < SYSTEM_ATE_MAX,
            f"14b: ATE {out['final_ate_rmse']:.4f} m is not under {SYSTEM_ATE_MAX}")
    require(ev["mean_psnr"] > SYSTEM_PSNR_MIN,
            f"14b: PSNR {ev['mean_psnr']:.2f} dB is not over {SYSTEM_PSNR_MIN}")
    return c["launches"]


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
    spills = sum(int(x) for x in re.findall(r"(\d+) bytes spill (?:stores|loads)",
                                            kernels.build_log("composite")))
    shapes = {}
    for name in kernels.SLAB_KERNELS:
        shapes[name] = kernels.slab_kernel_info(name, 32)
        line("launch", kernel=name, tile=32, **shapes[name])
    line("build", composite_spill_bytes=spills)
    require(spills == 0 and all(v["local_bytes"] == 0 for v in shapes.values()),
            "a slab kernel spills registers")
    require(shapes["slab_bwd"]["ctas_per_sm"] >= 2, "slab_bwd runs under 2 blocks an SM")
    mb = kernels.build_log("microbench")
    regs = [int(r) for r in re.findall(r"Used (\d+) registers", mb)]
    line("build", microbench_variants=len(regs), registers=f"{min(regs)}-{max(regs)}",
         spill_bytes=sum(int(x) for x in re.findall(r"(\d+) bytes spill stores", mb)))

    # 2b. The binning kernels against their twin at the cells' widths.
    binning_phase(smi)

    # 3. Kernels against their plain twins, at bench widths.
    intr = Intrinsics(fx=520.9, fy=521.0, cx=W / 2, cy=H / 2, width=W, height=H)
    cfg = TrackerConfig(opacity_threshold=0.5, entry_capacity=210432)
    rcfg = make_raster_config(W, H, cfg.tile_size)
    K = cfg.tile_capacity
    params = roofline.bench_map(N, SEED, dev)
    eye, z3 = torch.eye(3, device=dev), torch.zeros(3, device=dev)
    feats, bins, slab_cfg = roofline.tracking_slab(dev, SEED)
    require(slab_cfg == rcfg and K == 2048, "tracking_slab is not the tracker's workload")
    args = (feats, bins.pstart_blk, bins.counts)
    order = kernels.tile_order(bins.counts)
    out_k, _ = kernels.slab_fwd(*args, order, rcfg, K, False)
    out_kt, touched_k = kernels.slab_fwd(*args, order, rcfg, K, True)
    out_p, touched_p = tile_raster._fwd_slab_plain(*args, rcfg, K, True)
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
    d_k = kernels.slab_bwd(*args, order, baux, rcfg)
    d_p = tile_raster._bwd_slab_plain(*args, baux, rcfg)
    torch.cuda.synchronize()
    err_bwd, ok = bwd_err(d_k, d_p)
    line("check", kernel="slab_bwd", max_abs_err=err_bwd,
         max_abs_plain=float(d_p.abs().max()))
    require(ok, "slab_bwd disagrees with its plain twin")
    slab_checks(args, order, rcfg, baux, K, "tracking")
    t_chunks = roofline.live_chunks(*args, rcfg)
    t_slots = roofline.active_warp_slots(*args, rcfg)
    tiles_line("tracking", t_chunks, bins.counts, t_slots)

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
    args2 = (feats2, pstart2, counts2)
    order2 = kernels.tile_order(counts2)
    o2k, t2k = kernels.slab_fwd(*args2, order2, s_rcfg, 512, True)
    o2p, t2p = tile_raster._fwd_slab_plain(*args2, s_rcfg, 512, True)
    g2 = torch.randn(o2p.shape, generator=torch.Generator(dev).manual_seed(3),
                     device=dev)
    b2 = tile_raster.bwd_aux(o2p, g2)
    d2k = kernels.slab_bwd(*args2, order2, b2, s_rcfg)
    d2p = tile_raster._bwd_slab_plain(*args2, b2, s_rcfg)
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
    track_path = (kernels.slab_fwd, kernels.slab_bwd, kernels.rows_to_channels,
                  kernels.tile_order)
    for k in track_path:
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
    launches = {k.__name__: k.launches for k in track_path}
    line("launches", iterations=n_iters, **launches)
    require(launches["slab_fwd"] >= n_iters + len(frames)
            and launches["slab_bwd"] >= n_iters
            and launches["rows_to_channels"] >= n_iters
            and launches["tile_order"] == launches["slab_fwd"],
            "a kernel of the tracking path did not launch on it (or the tile order "
            "was not built once per forward)")

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

    pairs = int(t_chunks.sum()) * roofline.CHUNK * rcfg.pixels
    active = t_slots["active"] * roofline.WARP_PIXELS
    feat_bytes = 10 * 4 * pairs // rcfg.pixels
    track_rows = {
        "slab_fwd": (lambda: kernels.slab_fwd(*args, order, rcfg, K, False),
                     lambda: tile_raster._fwd_slab_plain(*args, rcfg, K, False), None,
                     ALPHA_OPS * pairs + FWD_REST_OPS * active, FWD_OPS_PER_PAIR * pairs,
                     feat_bytes + out_p.numel() * 4),
        "slab_bwd": (lambda: kernels.slab_bwd(*args, order, baux, rcfg),
                     lambda: tile_raster._bwd_slab_plain(*args, baux, rcfg), None,
                     ALPHA_OPS * pairs + BWD_REST_OPS * active, BWD_OPS_PER_PAIR * pairs,
                     2 * feat_bytes + baux.numel() * 4),
        "rows_to_channels": (lambda: kernels.rows_to_channels(x),
                             lambda: tile_raster._rows_to_channels_plain(x),
                             lambda: x.t().contiguous(), 0, None, 2 * x.numel() * 4),
    }
    track_ms = {}
    for kname, (kfn, pfn, lfn, ops, log_ops, nbytes) in track_rows.items():
        t = time_kernel(kfn, pfn, lfn, ops, nbytes, log_ops=log_ops)
        track_ms[kname] = t["ms"]
        line("kernel", shape="tracking", name=kname, **t, card=repr(smi))
    line("kernel", shape="tracking", name="slab_fwd(touched)",
         ms=cuda_ms(lambda: kernels.slab_fwd(*args, order, rcfg, K, True), 20, graph=True),
         live_pairs=pairs, active_pairs=active,
         total_s=f"{time.perf_counter() - t_start:.1f}")
    order_ab(args, rcfg, baux, K, "tracking", smi)
    track_slab = (pairs, active, track_ms)

    # 6-8. The mapping path, its kernels and the roofline probe.
    report = mapping_phases(dev, smi, launches, track_slab)

    # 9. The SLAM system through its command line, with the refinement;
    # 10. the monocular system.
    sys_launches, refine_launches, sync = system_phase(smi)
    mono_launches = mono_phase(smi)
    # 11. The concurrent mode, its checkpoint and the resumes.
    async_launches = async_phase(smi, sync)
    # 12. The TUM layout: fixture, parser, system, OpenCV's absence.
    tum_launches = tum_phase(smi, sync)
    # 13. The live viewer; 14. the sharded mapper.
    viewer_launches = viewer_phase(smi)
    sharded_launches = sharded_phase(smi)
    for row in report:
        for path, counts in (("system", sys_launches), ("refine", refine_launches),
                             ("mono", mono_launches), ("async", async_launches),
                             ("tum", tum_launches), ("viewer", viewer_launches),
                             ("sharded", sharded_launches)):
            row[f"launches_{path}"] = counts[row["name"]]
            row["launches"] += counts[row["name"]]
    line("done", total_s=f"{time.perf_counter() - t_start:.1f}")

    print(smi)
    print(json.dumps({"kernels": report}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
