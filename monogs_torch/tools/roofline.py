"""Roofline probe: measured float32 and transcendental rates on the card,
and the slab kernels' floors at those rates (port of
scripts/bench_roofline.py).

    python -m monogs_torch.tools.roofline

1. `op_microbench` times the kernel of csrc/microbench.cu (the port of the
   TPU probe `op_microbench`): `lanes` independent chains of `n_rep` steps
   of one op class (fma, exp, log1p, div) on every element of a (blocks,
   1024, 128) block array, in ns per element-step. It is built with the
   slab kernels' own flags (-fmad=false, no fast math), so the rates are
   those of the slab kernels' own instructions.
2. `slab_pairs` counts the (pixel, slot) pairs the slab kernels evaluate
   on given bins: `padded` is every pair of every chunk a tile owns (the
   TPU script's count), `live` stops each tile where all its pixels
   saturate, as the kernels do.
3. `floors_ms` turns pairs into least times at the measured rates with a
   per-pair op mix: each transcendental or divide at its probe's per-step
   time, each other float32 operation at half the fma probe's (one fma
   step is a multiply and an add). mix="log" is the log-space work of the
   plain twins and the TPU kernels on every live pair; mix="linear" is
   what the CUDA kernels of csrc/composite.cu run (a running product for
   T): alpha, with its one expf, on every live pair, and the rest (the
   backward's divide among it) only on the pairs of the (warp, slot)s that
   `active_warp_slots` counts, as the kernels skip the others.

The floors sit beside the published-peak bound that chip_smoke.py reports;
they ignore memory and launch costs and assume the op classes do not
overlap. Every measurement here needs the card: on a machine without one
the entry point fails.
"""

from __future__ import annotations

import json
import sys

import torch

from ..ops import kernels
from ..ops.tile_raster import CHUNK, _SlabWalk, warm_cpu_math

OPS = ("fma", "exp", "log1p", "div")
PROBE_SHAPE = (256, 1024, 128)   # (blocks, P, C): the slab kernels' block
PROBE_REP, PROBE_LANES = 512, 4
# Per (pixel, slot) pair: transcendentals and divides by name, every other
# float32 operation (an fma counts as one) under "flop".
# Log space (the twins, the TPU kernels), every live pair: T = exp(log T +
# excl) and log1p(-alpha) a pair.
FWD_MIX = {"exp": 2, "log1p": 1, "flop": 28}
BWD_MIX = {"exp": 2, "log1p": 1, "div": 1, "flop": 59}
# Linear T (csrc/composite.cu). Every live pair pays for its alpha: dx, dy
# 2; power 9; clamp 1 and expf; alpha_raw, tests, min 4. The rest runs only
# on the pairs of a (warp, slot) with some nonzero alpha (`active_warp_slots`;
# the kernels skip the others after one vote). Both carry the chunk vote's
# log T: log1pf(-alpha) and its running sum 1. Forward: w 1; 4 fma + 1 add;
# 1 - alpha and the T product 2. Backward: w, 1 - alpha, the T product 3;
# g 4; prefix, S 2; dalpha 1 and the divide; mask, dpower 3; the thread's
# moments 9; the 10 gradients and the warp's reduce-scatter adds over PX = 4
# pixels ~5.
ALPHA_MIX = {"exp": 1, "flop": 16}
FWD_REST_MIX = {"log1p": 1, "flop": 9}
BWD_REST_MIX = {"log1p": 1, "div": 1, "flop": 28}
MIXES = ("log", "linear")
WARP_PIXELS = 128   # the pixels of one slab-kernel warp: 32 threads of PX = 4


def _step(a: torch.Tensor, op: str, k: int) -> torch.Tensor:
    """One chain step of lane k (0-based), the TPU probe's math."""
    if op == "exp":
        return torch.exp(-torch.abs(a)) + 1e-3 * (k + 1)
    if op == "log1p":
        return -torch.log1p(-torch.clamp_max(torch.abs(a), 0.9)) + 1e-3 * (k + 1)
    if op == "fma":
        return a * 0.9995 + 1e-4 * (k + 1)
    if op == "div":
        return 1.0 / (torch.abs(a) + 1.0 + 1e-3 * (k + 1))
    raise ValueError(f"op must be one of {OPS}, got {op!r}")


@torch.no_grad()
def op_chain_plain(x: torch.Tensor, op: str, n_rep: int, lanes: int) -> torch.Tensor:
    """Plain twin of the probe kernel: x (blocks, P, C) -> (1, P, C), each
    element's sum of `lanes` chains of `n_rep` steps, maximised over the
    blocks."""
    if op not in OPS:
        raise ValueError(f"op must be one of {OPS}, got {op!r}")
    if x.device.type == "cpu":
        warm_cpu_math()
    accs = [x * (1.0 + 0.01 * k) for k in range(lanes)]
    for _ in range(n_rep):
        accs = [_step(a, op, k) for k, a in enumerate(accs)]
    acc = accs[0]
    for a in accs[1:]:
        acc = acc + a
    return acc.amax(0, keepdim=True)


def probe_input(shape=PROBE_SHAPE, seed: int = 0, device="cuda") -> torch.Tensor:
    """Uniform [0, 1) input drawn from a seed on the device."""
    return torch.rand(shape, generator=torch.Generator(device).manual_seed(seed),
                      device=device)


def op_microbench(op: str, n_rep: int = PROBE_REP, blocks: int = PROBE_SHAPE[0],
                  lanes: int = PROBE_LANES, reps: int = 3) -> float:
    """ns per element-step of `op` on the card: CUDA events around `reps`
    launches after one warm-up launch."""
    if not torch.cuda.is_available():
        raise RuntimeError("op_microbench measures the card; no CUDA device")
    x = probe_input((blocks,) + PROBE_SHAPE[1:])
    kernels.op_microbench(x, op, n_rep, lanes)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        kernels.op_microbench(x, op, n_rep, lanes)
    end.record()
    torch.cuda.synchronize()
    n = x.numel() * n_rep * lanes
    return start.elapsed_time(end) / reps * 1e6 / n


def _walk(feats_cm, pstart_blk, counts, cfg):
    """The twins' chunk walk: yields (live (Tt,), alpha (Tt, P, CHUNK)) for
    each step, with the chunk skip applied."""
    walk = _SlabWalk(feats_cm, pstart_blk, counts, cfg)
    logT = torch.zeros((walk.Tt, cfg.pixels), device=feats_cm.device)
    for j in range(walk.n_steps):
        live, _, _, terms = walk.chunk(j, logT)
        yield live, terms[-1]
        logT = torch.where(live[:, None], logT + torch.log1p(-terms[-1]).sum(-1), logT)


@torch.no_grad()
def live_chunks(feats_cm, pstart_blk, counts, cfg) -> torch.Tensor:
    """(Tt,) chunks each tile walks before every one of its pixels
    saturates (the twins' chunk skip)."""
    n = torch.zeros(pstart_blk.shape[0], dtype=torch.int64, device=feats_cm.device)
    for live, _ in _walk(feats_cm, pstart_blk, counts, cfg):
        n += live
    return n


@torch.no_grad()
def active_warp_slots(feats_cm, pstart_blk, counts, cfg,
                      warp_pixels: int = WARP_PIXELS) -> dict:
    """Over the live chunks, the (warp, slot) pairs in which some pixel of
    the warp (`warp_pixels` consecutive pixels) has a nonzero alpha, beside
    all of them. The CUDA kernels skip the others
    after one warp vote. -> {"active": int, "total": int}."""
    active = total = 0
    for live, alpha in _walk(feats_cm, pstart_blk, counts, cfg):
        Tt, P, S = alpha.shape
        hit = (alpha > 0).reshape(Tt, P // warp_pixels, warp_pixels, S).any(2)
        active += int(hit[live].sum())
        total += int(live.sum()) * (P // warp_pixels) * S
    return {"active": active, "total": total}


@torch.no_grad()
def slab_pairs(feats_cm, pstart_blk, counts, cfg) -> dict:
    """(pixel, slot) pairs the slab kernels evaluate on these bins:
    {"padded": every chunk each tile owns, "live": up to where every pixel
    of the tile saturates (the kernels' chunk skip)}."""
    nct = (counts.to(torch.int64) + CHUNK - 1) // CHUNK
    per_chunk = CHUNK * cfg.pixels
    return {"padded": int(nct.sum()) * per_chunk,
            "live": int(live_chunks(feats_cm, pstart_blk, counts, cfg).sum()) * per_chunk}


def floors_ms(pairs: int, rates: dict, mix: str = "log",
              active_pairs: int | None = None) -> dict:
    """Least forward and forward+backward times (ms) at the measured
    per-step rates (ns). mix="log" charges FWD_MIX / BWD_MIX to each of
    `pairs` live pairs; mix="linear" charges ALPHA_MIX to each live pair
    and FWD_REST_MIX / BWD_REST_MIX to each of `active_pairs`, the pairs of
    the active warp-slots (active_warp_slots' "active" times the warp's
    pixels)."""
    t = dict(rates, flop=rates["fma"] / 2.0)

    def cost(m):
        return sum(n * t[k] for k, n in m.items()) / 1e6

    if mix == "log":
        fwd, bwd = pairs * cost(FWD_MIX), pairs * cost(BWD_MIX)
    elif mix == "linear":
        if active_pairs is None:
            raise ValueError('mix="linear" needs active_pairs')
        alpha = pairs * cost(ALPHA_MIX)
        fwd = alpha + active_pairs * cost(FWD_REST_MIX)
        bwd = alpha + active_pairs * cost(BWD_REST_MIX)
    else:
        raise ValueError(f"mix must be one of {MIXES}, got {mix!r}")
    return {"floor_fwd_ms": fwd, "floor_bwd_ms": bwd, "floor_fwdbwd_ms": fwd + bwd}

def bench_map(n: int, seed: int, device="cuda") -> dict:
    """bench.py's random map of `n` Gaussians, drawn with numpy from `seed`
    (xyz in [-2, 2]^2 x [0.8, 5], log-scales in [-5.5, -4], opacity logits
    N(0, 1), rgb in [0, 1))."""
    import numpy as np

    rng = np.random.default_rng(seed)
    p = {"xyz": np.concatenate([rng.uniform(-2.0, 2.0, (n, 2)),
                                rng.uniform(0.8, 5.0, (n, 1))], axis=1),
         "log_scales": rng.uniform(-5.5, -4.0, (n, 3)),
         "quats": rng.normal(size=(n, 4)) + np.array([2.0, 0, 0, 0]),
         "opacity_logit": rng.normal(size=(n,)), "rgb": rng.uniform(size=(n, 3))}
    return {k: torch.as_tensor(v, dtype=torch.float32, device=device) for k, v in p.items()}


@torch.no_grad()
def room_projection(n: int, frame: int, intr, device="cuda", seed: int = 0):
    """The synthetic room of data/synthetic.py (150,000 Gaussians, seed 0)
    cut to `n` rows drawn with numpy from `seed`, their scales grown by
    sqrt(150,000 / n) so that the rows still cover the walls, projected at
    the room orbit's w2c pose of `frame` (motion 0.016, as the benchmark's
    room) -> ProjectedChannels with the opacity 0 where not valid."""
    import numpy as np

    from ..data.synthetic import _orbit_trajectory, _room_scene
    from ..ops.projection import project_gaussians_ch

    total = 150_000
    means, scales, quats, opac, _ = _room_scene(total, 0)
    rows = np.random.default_rng(seed).choice(total, n, replace=False)
    pose = torch.as_tensor(_orbit_trajectory(frame + 1, 0.016)[frame], dtype=torch.float32,
                           device=device)

    def dev(a):
        return torch.as_tensor(a[rows], dtype=torch.float32, device=device)

    z3 = torch.zeros(3, device=device)
    p = project_gaussians_ch(dev(means), dev(scales) * (total / n) ** 0.5, dev(quats),
                             dev(opac), pose[:3, :3], pose[:3, 3], z3, z3, intr)
    return p._replace(opacity=torch.where(p.valid, p.opacity, torch.zeros_like(p.opacity)))


@torch.no_grad()
def slab_inputs(params, intr, R, t, tile_size: int, tile_capacity: int,
                entry_capacity, max_dup: int = 4, max_dup_gen: int = 16):
    """One view's bins and its (1, 16, E_cap) slab at the w2c pose (R, t)."""
    from ..models.gaussian_map import get_opacity, get_scales
    from ..ops.binning import tile_bin
    from ..ops.projection import project_gaussians_ch
    from ..ops.tile_raster import pack_features_slab

    z3 = torch.zeros(3, device=R.device)
    pr = project_gaussians_ch(params["xyz"], get_scales(params, False), params["quats"],
                              get_opacity(params), R, t, z3, z3, intr)
    opa = torch.where(pr.valid, pr.opacity, torch.zeros_like(pr.opacity))
    bins = tile_bin(None, pr.radius, pr.depth, pr.valid, img_w=intr.width,
                    img_h=intr.height, tile_size=tile_size, tile_capacity=tile_capacity,
                    max_dup=max_dup, entry_capacity=entry_capacity, opacity=opa,
                    conic=(pr.ca, pr.cb, pr.cc), uv=(pr.u, pr.v), max_dup_gen=max_dup_gen)
    feats = pack_features_slab(pr.u, pr.v, pr.ca, pr.cb, pr.cc, opa, params["rgb"],
                               pr.depth, bins.gauss_of_pos, bins.gsort_pos,
                               bins.gseg_start, bins.g_last, max_dup)
    return bins, feats[None].contiguous()


def tracking_slab(device="cuda", seed: int = 0):
    """The tracking workload's slab at the identity pose: bench.py's widths
    (640x480, 100k Gaussians, tile 32, K 2048, max_dup 4 / 16, entry
    capacity 210,432) on `bench_map(100_000, seed)`. -> (feats_cm
    (1, 16, E_cap), bins, RasterConfig)."""
    from ..ops.graphics import Intrinsics
    from ..ops.tile_raster import make_raster_config

    W, H = 640, 480
    intr = Intrinsics(fx=520.9, fy=521.0, cx=W / 2, cy=H / 2, width=W, height=H)
    bins, feats = slab_inputs(bench_map(100_000, seed, device), intr,
                              torch.eye(3, device=device), torch.zeros(3, device=device),
                              32, 2048, 210432)
    return feats, bins, make_raster_config(W, H, 32)


def main() -> int:
    if not torch.cuda.is_available():
        print("roofline: no CUDA device; the probe measures the card",
              file=sys.stderr)
        return 2
    rates = {op: op_microbench(op) for op in OPS}
    for op, ns in rates.items():
        print(f"{op}: {ns:.6f} ns/elem-step ({1.0 / ns:.2f} Gstep/s)", flush=True)
    feats, bins, cfg = tracking_slab()
    pairs = slab_pairs(feats, bins.pstart_blk, bins.counts, cfg)
    slots = active_warp_slots(feats, bins.pstart_blk, bins.counts, cfg)
    active = slots["active"] * WARP_PIXELS
    out = {"device": torch.cuda.get_device_name(0), "rates_ns_per_step": rates,
           "pairs": pairs, "active_pairs": active, "entries": int(bins.counts.sum())}
    for which in ("live", "padded"):
        out.update({f"{k}_{which}_log": v
                    for k, v in floors_ms(pairs[which], rates).items()})
    out.update({f"{k}_live_linear": v
                for k, v in floors_ms(pairs["live"], rates, "linear", active).items()})
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
