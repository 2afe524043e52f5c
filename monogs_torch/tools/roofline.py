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
3. `floors_ms` turns pairs into least times at the measured rates with the
   port's own per-pair op mix (csrc/composite.cu): each transcendental or
   divide at its probe's per-step time, each other float32 operation at
   half the fma probe's (one fma step is a multiply and an add).

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
# Per live (pixel, slot) pair, from csrc/composite.cu: transcendentals and
# divides by name, every other float32 operation under "flop".
FWD_MIX = {"exp": 2, "log1p": 1, "flop": 28}
BWD_MIX = {"exp": 2, "log1p": 1, "div": 1, "flop": 59}


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


@torch.no_grad()
def slab_pairs(feats_cm, pstart_blk, counts, cfg) -> dict:
    """(pixel, slot) pairs the slab kernels evaluate on these bins:
    {"padded": every chunk each tile owns, "live": up to where every pixel
    of the tile saturates (the kernels' chunk skip)}."""
    walk = _SlabWalk(feats_cm, pstart_blk, counts, cfg)
    P = cfg.pixels
    padded = int(walk.nct.sum()) * CHUNK * P
    logT = torch.zeros((walk.Tt, P), device=feats_cm.device)
    live = 0
    for j in range(walk.n_steps):
        ok, _, _, terms = walk.chunk(j, logT)
        live += int(ok.sum())
        logT = torch.where(ok[:, None], logT + torch.log1p(-terms[-1]).sum(-1), logT)
    return {"padded": padded, "live": live * CHUNK * P}


def floors_ms(pairs: int, rates: dict) -> dict:
    """Least forward and forward+backward times (ms) of `pairs` pairs at
    the measured per-step rates (ns) with the port's per-pair op mix."""
    t = dict(rates, flop=rates["fma"] / 2.0)
    fwd = pairs * sum(n * t[k] for k, n in FWD_MIX.items()) / 1e6
    bwd = pairs * sum(n * t[k] for k, n in BWD_MIX.items()) / 1e6
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
    out = {"device": torch.cuda.get_device_name(0), "rates_ns_per_step": rates,
           "pairs": pairs, "entries": int(bins.counts.sum()),
           **{f"{k}_live": v for k, v in floors_ms(pairs["live"], rates).items()},
           **{f"{k}_padded": v for k, v in floors_ms(pairs["padded"], rates).items()}}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
