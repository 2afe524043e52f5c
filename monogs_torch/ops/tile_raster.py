"""Tile-based alpha compositing (port of monogs_tpu/ops/tile_raster.py).

The differentiable boundary is `composite_slab(feats_cm)`: per-slab-position
2D Gaussian features in the (n_img, 16, entry_capacity) channel-major slab
layout that ops/binning.py builds. Gradients with respect to the 3D
parameters and the camera pose flow by autograd through the projection and
the feature gather (`pack_features_slab`) that produce `feats_cm`.

Feature channels (10 used, 6 spare):
    0: u   1: v   2: conic_a   3: conic_b   4: conic_c
    5: opacity (activated, 0 for padding)   6, 7, 8: r, g, b   9: depth
Padding positions carry the all-zero sentinel Gaussian (opacity 0).

Compositing math, per pixel, slots depth-sorted front to back:
    power_k = -0.5 (a dx^2 + 2 b dx dy + c dy^2),  dx = x - u (tile-local)
    alpha_k = min(opacity_k exp(power_k), 0.99), zero if power_k > 0 or
              alpha_k < 1/255
    T_k     = prod_{j<k} (1 - alpha_j), kept as log T
    out     = sum_k alpha_k T_k [r, g, b, depth, 1]
A tile skips a whole CHUNK of slots once every one of its pixels (padding
pixels included) has log T < LOG_SKIP. The backward uses
    dL/dalpha_k = T_k g_k - S_k / (1 - alpha_k),  S_k = sum_{j>k} w_j g_j.

Kernels. Each of the three compositing-path TPU kernels has a
hand-written Hopper kernel in ops/kernels.py and a plain PyTorch twin here:
    _fwd_slab  -> kernels.slab_fwd       (CUDA, csrc/composite.cu)
    _bwd_slab  -> kernels.slab_bwd       (CUDA, csrc/composite.cu)
    rows_to_channels -> kernels.rows_to_channels (Triton, csrc/relayout.py;
                        (N, 16) or the window's batched (Wn, N, 16))
`composite_slab` first launches kernels.tile_order (twin `_tile_order_plain`)
once, for both slab kernels: it only sets the order their thread blocks
take the tiles in.
The dispatchers take the plain twin only for a CPU tensor; a CUDA tensor
launches the kernel or raises. The plain twins keep the log-space
arithmetic of the TPU kernels: in-chunk prefixes are sequential float32
sums (`_seq_prefix`). The CUDA kernels compute alpha in the twins'
operations, carry T as a running product, and carry the twins' log T only
for the `touched` count, so on one device `touched` is bit-identical
between a kernel and its twin and the images agree to float32 rounding.

CPU determinism. In a fresh process the first float32 `torch.exp` that
runs on several intra-op threads can return wrong values on one worker
thread's chunk (relative errors up to 1.5e-4; seen with torch 2.13.0+cpu,
AVX512, 8 threads, on the exp of a `clamp_max` output), while every later
call is right. A single-threaded call of each transcendental the twins use
first removes it (`warm_cpu_math`, run once at the first CPU `_alpha`, which
the dense oracle and both slab twins go through before any other
transcendental), so they give the same bits on their first call as on
every later one.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import kernels
from .binning import ALPHA_EPS, CHUNK, SLAB

ALPHA_MAX = 0.99
TOUCH_T_MIN = 1e-4   # transmittance floor for the n_touched signal
LOG_SKIP = -9.2103   # ln(1e-4): the reference's per-pixel termination
FEAT_ROWS = 16
N_FEAT = 10


class RasterConfig(NamedTuple):
    tiles_x: int
    tiles_y: int
    tile_size: int
    img_w: int
    img_h: int

    @property
    def num_tiles(self) -> int:
        return self.tiles_x * self.tiles_y

    @property
    def pixels(self) -> int:
        return self.tile_size * self.tile_size


def make_raster_config(img_w: int, img_h: int, tile_size: int = 16) -> RasterConfig:
    return RasterConfig(tiles_x=-(-img_w // tile_size),
                        tiles_y=-(-img_h // tile_size),
                        tile_size=tile_size, img_w=img_w, img_h=img_h)


def _tile_pixel_coords(cfg: RasterConfig, device, dtype=torch.float32):
    """Tile-local pixel-centre coords (P,) each, row-major."""
    p = torch.arange(cfg.pixels, device=device)
    x = (p % cfg.tile_size).to(dtype) + 0.5
    y = (p // cfg.tile_size).to(dtype) + 0.5
    return x, y


def _tile_origins(cfg: RasterConfig, total_tiles: int, device,
                  dtype=torch.float32):
    """Tile origins; tile ids wrap every cfg.num_tiles (batched images)."""
    t = torch.arange(total_tiles, device=device) % cfg.num_tiles
    ox = (t % cfg.tiles_x).to(dtype) * cfg.tile_size
    oy = (t // cfg.tiles_x).to(dtype) * cfg.tile_size
    return ox, oy


def _pix_valid(cfg: RasterConfig, ox, oy, px, py):
    """(T, P) bool: the pixel lies inside the image."""
    return (((ox[:, None] + px[None, :] - 0.5) < cfg.img_w)
            & ((oy[:, None] + py[None, :] - 0.5) < cfg.img_h))


def _alpha(u, v, a, b, c, opa, px, py):
    """Per-(tile, pixel, slot) alpha from (T, 1, S) slot features and (P, 1)
    tile-local pixel coords: returns dx, dy, expp, alpha_raw, ok, alpha."""
    if u.device.type == "cpu":
        warm_cpu_math()
    dx = px - u
    dy = py - v
    power = -0.5 * (a * dx * dx + c * dy * dy) - b * dx * dy
    expp = torch.exp(torch.clamp_max(power, 0.0))
    alpha_raw = opa * expp
    ok = (power <= 0.0) & (alpha_raw >= ALPHA_EPS)
    alpha = torch.where(ok, torch.clamp_max(alpha_raw, ALPHA_MAX),
                        torch.zeros_like(alpha_raw))
    return dx, dy, expp, alpha_raw, ok, alpha


@kernels._once
def warm_cpu_math() -> None:
    """Run torch.exp and torch.log1p once on the CPU on one intra-op
    thread (see the module docstring); later multi-threaded calls then
    compute right from the first. Once per process, under a lock: a second
    host thread (the concurrent SLAM mode's mapper) waits for it, and never
    reads the thread count while it is set to 1."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with torch.no_grad():
            x = torch.linspace(-20.0, 0.0, 4096)
            torch.log1p(-0.5 * torch.exp(x))
    finally:
        torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# Dense oracle (plain autograd).
# ---------------------------------------------------------------------------


def composite_tiles_ref(feats: torch.Tensor, cfg: RasterConfig, with_touched: bool = True):
    """Vectorised dense compositing, differentiable by autograd.

    feats: (T, K, 16) -> (out (T, P, 8), touched (T, K) int32, or None
    without with_touched)

    A slot of zero opacity has zero alpha, so it neither adds to a pixel
    nor moves its transmittance; each tile's result depends on its own
    slots alone. So only the tiles that hold a slot of nonzero opacity are
    composited, over their first K' slots, K' the last such slot rounded
    up to a multiple of 32 (one host read finds both): every other tile,
    such as all of a zero-pose padding slot of a keyframe window, composites
    to zeros and touches nothing. The results are those of the whole
    (T, K) computation, bit for bit.
    """
    T, K = feats.shape[:2]
    dev = feats.device
    used = (feats[..., 5].ne(0) * torch.arange(1, K + 1, device=dev)).amax(1).cpu()
    live = torch.nonzero(used).squeeze(1).to(dev)
    k_live = min(K, -(-int(used.max()) // 32) * 32) if T else 0
    px, py = _tile_pixel_coords(cfg, dev, feats.dtype)
    ox, oy = _tile_origins(cfg, T, dev, feats.dtype)
    ox, oy, fl = ox[live], oy[live], feats.index_select(0, live)[:, :k_live]
    f = fl.permute(2, 0, 1)[:, :, None, :]             # (16, T', 1, K')
    u = f[0] - ox[:, None, None]
    v = f[1] - oy[:, None, None]
    _, _, _, _, ok, alpha = _alpha(u, v, f[2], f[3], f[4], f[5],
                                   px[:, None], py[:, None])    # (T', P, K')
    one_m = 1.0 - alpha
    Tk = torch.cumprod(torch.cat([torch.ones_like(one_m[..., :1]),
                                  one_m[..., :-1]], dim=-1), dim=-1)
    w = alpha * Tk
    colors = torch.stack([fl[..., 6], fl[..., 7], fl[..., 8],
                          fl[..., 9], torch.ones_like(fl[..., 9])], -1)
    acc = torch.matmul(w, colors)                        # (T', P, 5)
    out = feats.new_zeros((T, cfg.pixels, 8)).index_copy(
        0, live, torch.cat([acc, torch.zeros_like(acc[..., :3])], dim=-1))
    if not with_touched:
        return out, None
    valid = _pix_valid(cfg, ox, oy, px, py)
    touched = (ok & (Tk > TOUCH_T_MIN) & valid[:, :, None]).sum(1, dtype=torch.int32)
    return out, torch.zeros((T, K), dtype=torch.int32, device=dev).index_copy(
        0, live, torch.nn.functional.pad(touched, (0, K - k_live)))


# ---------------------------------------------------------------------------
# Slab compositing: plain twins of the CUDA kernels, and their dispatchers.
# ---------------------------------------------------------------------------


def _seq_prefix(x: torch.Tensor):
    """Exclusive prefix along the last axis as sequential float32 sums (the
    kernels' running-scalar order): returns (exclusive (..., S), total)."""
    run = torch.zeros_like(x[..., 0])
    excl = torch.empty_like(x)
    for k in range(x.shape[-1]):
        excl[..., k] = run
        run = run + x[..., k]
    return excl, run


class _SlabWalk:
    """Shared chunk walk of the plain twins: one step per CHUNK of slots,
    vectorised over tiles; a tile is live in step j while j < its chunk
    count and some pixel still has log T > LOG_SKIP."""

    def __init__(self, feats_cm, pstart_blk, counts, cfg: RasterConfig):
        n_img, _, E_cap = feats_cm.shape
        dev = feats_cm.device
        self.Tt = pstart_blk.shape[0]
        self.flat = feats_cm.permute(1, 0, 2).reshape(FEAT_ROWS, n_img * E_cap)
        self.base = pstart_blk.to(torch.int64) * SLAB
        self.nct = (counts.to(torch.int64) + CHUNK - 1) // CHUNK
        self.n_steps = int(self.nct.max()) if self.Tt else 0
        self.slot = torch.arange(CHUNK, device=dev)
        self.px, self.py = _tile_pixel_coords(cfg, dev, feats_cm.dtype)
        self.ox, self.oy = _tile_origins(cfg, self.Tt, dev, feats_cm.dtype)
        self.valid = _pix_valid(cfg, self.ox, self.oy, self.px, self.py)

    def chunk(self, j, logT):
        """Step j: (live (Tt,), pos (Tt, CHUNK), f (16, Tt, 1, CHUNK), alpha
        terms (Tt, P, CHUNK))."""
        live = (j < self.nct) & (logT.amax(1) > LOG_SKIP)
        pos = self.base[:, None] + j * CHUNK + self.slot
        pos = torch.where(live[:, None], pos, torch.zeros_like(pos))
        f = self.flat[:, pos][:, :, None, :]
        u = f[0] - self.ox[:, None, None]
        v = f[1] - self.oy[:, None, None]
        terms = _alpha(u, v, f[2], f[3], f[4], f[5],
                       self.px[:, None], self.py[:, None])
        return live, pos, f, terms


@torch.no_grad()
def _fwd_slab_plain(feats_cm, pstart_blk, counts, cfg: RasterConfig, K: int,
                    emit_touched: bool = True):
    """Plain twin of the forward kernel: -> (out (Tt, P, 8), touched (Tt, K))."""
    walk = _SlabWalk(feats_cm, pstart_blk, counts, cfg)
    Tt, P, dev, dt = walk.Tt, cfg.pixels, feats_cm.device, feats_cm.dtype
    logT = torch.zeros((Tt, P), dtype=dt, device=dev)
    acc = torch.zeros((Tt, P, 8), dtype=dt, device=dev)
    touched = torch.zeros((Tt, K), dtype=torch.int32, device=dev)
    for j in range(walk.n_steps):
        live, _, f, (_, _, _, _, ok, alpha) = walk.chunk(j, logT)
        log1m = torch.log1p(-alpha)
        excl, total = _seq_prefix(log1m)
        Tk = torch.exp(logT[:, :, None] + excl)
        w = torch.where(live[:, None, None], alpha * Tk, torch.zeros_like(Tk))
        for c in range(4):
            acc[..., c] += (w * f[6 + c]).sum(-1)
        acc[..., 4] += w.sum(-1)
        if emit_touched:
            hit = ok & (Tk > TOUCH_T_MIN) & walk.valid[:, :, None]
            touched[:, j * CHUNK:(j + 1) * CHUNK] = torch.where(
                live[:, None], hit.sum(1, dtype=torch.int32),
                torch.zeros_like(touched[:, :CHUNK]))
        logT = torch.where(live[:, None], logT + total, logT)
    return acc, touched


@torch.no_grad()
def _bwd_slab_plain(feats_cm, pstart_blk, counts, baux, cfg: RasterConfig):
    """Plain twin of the backward kernel.

    baux: (Tt, 8, P) rows [g_r, g_g, g_b, g_depth, g_alpha, A, 0, 0] with
    A = sum_j w_j g_j per pixel. -> dfeats_cm, shaped like feats_cm."""
    walk = _SlabWalk(feats_cm, pstart_blk, counts, cfg)
    n_img, _, E_cap = feats_cm.shape
    Tt, P, dev, dt = walk.Tt, cfg.pixels, feats_cm.device, feats_cm.dtype
    gv = baux[:, 0:5, :, None]                           # (Tt, 5, P, 1)
    A = baux[:, 5, :, None]
    dflat = torch.zeros((FEAT_ROWS, n_img * E_cap), dtype=dt, device=dev)
    logT = torch.zeros((Tt, P), dtype=dt, device=dev)
    wg_pref = torch.zeros((Tt, P), dtype=dt, device=dev)
    for j in range(walk.n_steps):
        live, pos, f, (dx, dy, expp, alpha_raw, ok, alpha) = walk.chunk(j, logT)
        a, b, c = f[2], f[3], f[4]
        log1m = torch.log1p(-alpha)
        excl, total = _seq_prefix(log1m)
        Tk = torch.exp(logT[:, :, None] + excl)
        w = alpha * Tk
        g = gv[:, 0] * f[6] + gv[:, 1] * f[7] + gv[:, 2] * f[8] + \
            gv[:, 3] * f[9] + gv[:, 4]
        wg = w * g
        wg_excl, wg_total = _seq_prefix(wg)
        S = A - (wg_pref[:, :, None] + (wg_excl + wg))
        dalpha = Tk * g - S / (1.0 - alpha)
        dar = torch.where(ok & (alpha_raw < ALPHA_MAX), dalpha,
                          torch.zeros_like(dalpha))
        dpower = dar * alpha_raw
        d10 = torch.stack([
            (dpower * (a * dx + b * dy)).sum(1),
            (dpower * (b * dx + c * dy)).sum(1),
            (-0.5 * dpower * dx * dx).sum(1),
            (-dpower * dx * dy).sum(1),
            (-0.5 * dpower * dy * dy).sum(1),
            (dar * expp).sum(1),
            (w * gv[:, 0]).sum(1),
            (w * gv[:, 1]).sum(1),
            (w * gv[:, 2]).sum(1),
            (w * gv[:, 3]).sum(1),
        ])                                               # (10, Tt, CHUNK)
        dflat[:N_FEAT, pos[live]] = d10[:, live]
        logT = torch.where(live[:, None], logT + total, logT)
        wg_pref = torch.where(live[:, None], wg_pref + wg_total, wg_pref)
    return dflat.reshape(FEAT_ROWS, n_img, E_cap).permute(1, 0, 2).contiguous()


def _tile_order_plain(counts: torch.Tensor) -> torch.Tensor:
    """Plain twin of the tile-order kernel: tile ids by descending chunk
    count (capped at 63), ties in id order."""
    key = torch.clamp_max((counts.to(torch.int64) + CHUNK - 1) // CHUNK, 63)
    return torch.argsort(key, descending=True, stable=True).to(torch.int32)


def _fwd_slab(feats_cm, pstart_blk, counts, order, cfg: RasterConfig, K: int,
              emit_touched: bool = True):
    if feats_cm.device.type == "cpu":
        return _fwd_slab_plain(feats_cm, pstart_blk, counts, cfg, K,
                               emit_touched)
    return kernels.slab_fwd(feats_cm, pstart_blk, counts, order, cfg, K,
                            emit_touched)


def _bwd_slab(feats_cm, pstart_blk, counts, order, baux, cfg: RasterConfig):
    if feats_cm.device.type == "cpu":
        return _bwd_slab_plain(feats_cm, pstart_blk, counts, baux, cfg)
    return kernels.slab_bwd(feats_cm, pstart_blk, counts, order, baux, cfg)


class _CompositeSlab(torch.autograd.Function):
    @staticmethod
    def forward(ctx, feats_cm, pstart_blk, counts, cfg, K, emit_touched):
        # The kernels' tile order, built once for the forward and the
        # backward (the plain twins walk the tiles in id order).
        order = None if feats_cm.device.type == "cpu" else kernels.tile_order(counts)
        out, touched = _fwd_slab(feats_cm, pstart_blk, counts, order, cfg, K,
                                 emit_touched)
        ctx.save_for_backward(feats_cm, pstart_blk, counts, order, out)
        ctx.cfg = cfg
        ctx.mark_non_differentiable(touched)
        return out, touched

    @staticmethod
    def backward(ctx, g_out, _g_touched):
        feats_cm, pstart_blk, counts, order, out = ctx.saved_tensors
        dfeats = _bwd_slab(feats_cm, pstart_blk, counts, order,
                           bwd_aux(out, g_out), ctx.cfg)
        return dfeats, None, None, None, None, None


def bwd_aux(out: torch.Tensor, g_out: torch.Tensor) -> torch.Tensor:
    """The backward kernel's per-pixel input (Tt, 8, P): rows [g_r, g_g,
    g_b, g_depth, g_alpha, A, 0, 0], with A = sum_j w_j g_j recovered from
    the forward output (out[..., 0:5] = sum_j w_j [r, g, b, d, 1]_j)."""
    g5 = g_out[:, :, 0:5]
    A = (out[:, :, 0:5] * g5).sum(-1, keepdim=True)
    return torch.cat([g5, A, torch.zeros_like(g_out[:, :, 0:2])],
                     dim=-1).transpose(1, 2).contiguous()


def composite_slab(feats_cm: torch.Tensor, pstart_blk: torch.Tensor,
                   counts: torch.Tensor, cfg: RasterConfig,
                   tile_capacity: int, emit_touched: bool = True):
    """Differentiable slab compositing.

    feats_cm: (n_img, 16, entry_capacity) channel-major slab features
    pstart_blk / counts: (T_total,) per-tile first SLAB block (global over
        the n_img slabs) and entry count. The kernels give each tile one
        thread block that walks its own segment, so the JAX package's
        per-block `owner_blk` / `seg_first` are not needed here.
    emit_touched=False skips the n_touched count; `touched` is then zero.
    -> (out (T_total, P, 8), touched (T_total, K) int32)
    """
    return _CompositeSlab.apply(feats_cm, pstart_blk, counts, cfg,
                                tile_capacity, emit_touched)


# ---------------------------------------------------------------------------
# Relayout and slab feature gather.
# ---------------------------------------------------------------------------


def _rows_to_channels_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain twin of the relayout kernel: (..., N, C) -> (..., C, N) by
    columns."""
    return torch.stack([x[..., c] for c in range(x.shape[-1])], dim=-2)


def rows_to_channels(x: torch.Tensor) -> torch.Tensor:
    """(N, 16) row-major -> (16, N) channel-major, or a batch (B, N, 16) ->
    (B, 16, N) in one kernel launch."""
    if x.device.type == "cpu":
        return _rows_to_channels_plain(x)
    return kernels.rows_to_channels(x)


def _segsum_last(dpos, gsort_pos, gseg_start, g_last, max_dup):
    """Per-Gaussian sums of per-slab-position rows: gather rows into
    gaussian-sorted order, run a segmented Hillis-Steele inclusive scan
    (ceil(log2(max_dup)) shift-add steps), read each segment's total at its
    last entry. dpos: (E_cap, C) -> (N, C)."""
    Ecap, C = dpos.shape
    rows = dpos[gsort_pos.to(torch.int64)]
    flag = gseg_start.bool()
    k = 1
    while k < max_dup:
        prev = torch.cat([rows.new_zeros((k, C)), rows[:-k]])
        pflag = torch.cat([flag.new_ones((k,)), flag[:-k]])
        rows = rows + torch.where(flag[:, None], torch.zeros_like(prev), prev)
        flag = flag | pflag
        k *= 2
    g = rows[torch.clamp_max(g_last, Ecap - 1).to(torch.int64)]
    return torch.where((g_last < Ecap)[:, None], g, torch.zeros_like(g))


def _gather_cm(feats_full, gauss_of_pos):
    """(N+1, 16) rows gathered at (E_cap,) ids straight into (16, E_cap)."""
    return feats_full.t().index_select(1, gauss_of_pos.to(torch.int64))


class _GatherPos(torch.autograd.Function):
    @staticmethod
    def forward(ctx, feats_full, gauss_of_pos, gsort_pos, gseg_start, g_last,
                max_dup):
        ctx.save_for_backward(gsort_pos, gseg_start, g_last)
        ctx.max_dup = max_dup
        return _gather_cm(feats_full, gauss_of_pos)

    @staticmethod
    def backward(ctx, dpos_cm):
        gsort_pos, gseg_start, g_last = ctx.saved_tensors
        g = _segsum_last(dpos_cm.t(), gsort_pos, gseg_start, g_last,
                         ctx.max_dup)
        return (torch.cat([g, g.new_zeros((1, g.shape[1]))]),
                None, None, None, None, None)


def gather_pos(feats_full, gauss_of_pos, gsort_pos, gseg_start, g_last,
               max_dup: int) -> torch.Tensor:
    """(N+1, 16) features + (E_cap,) slab gaussian ids -> (16, E_cap); the
    backward reduces per-position gradients through the gaussian-sorted
    slab view (_segsum_last), with no scatter."""
    return _GatherPos.apply(feats_full, gauss_of_pos, gsort_pos, gseg_start,
                            g_last, max_dup)


class _PackFeaturesWindow(torch.autograd.Function):
    @staticmethod
    def forward(ctx, u, v, ca, cb, cc, opacity, depth, r, g, b, gop_w,
                gsort_pos_w, gseg_start_w, g_last_w, max_dup):
        Wn, N = u.shape
        E_cap = gop_w.shape[1]
        rgb = (r, g, b)
        # (Wn, N+1, 16) per-keyframe tables with the sentinel row N; the
        # shared rgb is broadcast here, outside autograd.
        table = u.new_zeros((Wn, N + 1, FEAT_ROWS))
        for c, ch in enumerate((u, v, ca, cb, cc, opacity, *rgb, depth)):
            table[:, :N, c] = ch
        img = torch.arange(Wn, device=u.device)[:, None]
        idx = (gop_w.to(torch.int64) + img * (N + 1)).reshape(-1)
        rows = table.reshape(-1, FEAT_ROWS).index_select(0, idx)
        ctx.save_for_backward(gsort_pos_w, gseg_start_w, g_last_w)
        ctx.max_dup, ctx.N = max_dup, N
        return rows.reshape(Wn, E_cap, FEAT_ROWS).transpose(1, 2).contiguous()

    @staticmethod
    def backward(ctx, dcm):
        gsort_pos_w, gseg_start_w, g_last_w = ctx.saved_tensors
        Wn, _, E_cap = dcm.shape
        # The window's gaussian-sorted slab views, concatenated: every
        # keyframe's list starts a segment (gseg_start[0] = 1), so one
        # segmented scan over Wn * E_cap rows never crosses keyframes.
        off = torch.arange(Wn, device=dcm.device)[:, None] * E_cap
        gsp = (gsort_pos_w.to(torch.int64) + off).reshape(-1)
        glast = torch.where(g_last_w < E_cap, g_last_w.to(torch.int64) + off,
                            torch.full_like(off, Wn * E_cap)).reshape(-1)
        dpos = dcm.transpose(1, 2).reshape(Wn * E_cap, FEAT_ROWS)
        gr = _segsum_last(dpos, gsp, gseg_start_w.reshape(-1), glast,
                          ctx.max_dup).reshape(Wn, ctx.N, FEAT_ROWS)
        grT = rows_to_channels(gr)                         # (Wn, 16, N)
        return (grT[:, 0], grT[:, 1], grT[:, 2], grT[:, 3], grT[:, 4],
                grT[:, 5], grT[:, 9], grT[:, 6].sum(0), grT[:, 7].sum(0),
                grT[:, 8].sum(0), None, None, None, None, None)


def pack_features_window(u, v, ca, cb, cc, opacity, depth, r, g, b,
                         gauss_of_pos_w, gsort_pos_w, gseg_start_w, g_last_w,
                         max_dup: int) -> torch.Tensor:
    """Batched-window pack and slab gather: per-keyframe (Wn, N) channels
    and the SHARED (N,) rgb channels -> (Wn, 16, E_cap) kernel layout.

    The rgb channels are broadcast across keyframes inside the forward
    (never as an autograd expand), and their gradients are summed over the
    window in the backward. The backward reduces per-position gradients per
    Gaussian through the gaussian-sorted slab views (_segsum_last, one scan
    over the whole window) and relayouts the (Wn, N, 16) result to
    channel-major in ONE launch of kernel 3 (rows_to_channels)."""
    return _PackFeaturesWindow.apply(u, v, ca, cb, cc, opacity, depth, r, g,
                                     b, gauss_of_pos_w, gsort_pos_w,
                                     gseg_start_w, g_last_w, max_dup)


def _stack_features_ch(u, v, ca, cb, cc, opacity, r, g, b, depth):
    """(N,) channels -> (N+1, 16) feature rows; row N is the all-zero
    sentinel. opacity must already be masked by validity."""
    f = torch.stack([u, v, ca, cb, cc, opacity, r, g, b, depth], dim=1)
    f = torch.cat([f, f.new_zeros((f.shape[0], FEAT_ROWS - N_FEAT))], dim=1)
    return torch.cat([f, f.new_zeros((1, FEAT_ROWS))], dim=0)


class _PackFeaturesSlab(torch.autograd.Function):
    @staticmethod
    def forward(ctx, u, v, ca, cb, cc, opacity, rgb, depth, gauss_of_pos,
                gsort_pos, gseg_start, g_last, max_dup):
        feats_full = _stack_features_ch(u, v, ca, cb, cc, opacity, rgb[:, 0],
                                        rgb[:, 1], rgb[:, 2], depth)
        ctx.save_for_backward(gsort_pos, gseg_start, g_last)
        ctx.max_dup = max_dup
        return _gather_cm(feats_full, gauss_of_pos)

    @staticmethod
    def backward(ctx, dcm):
        gsort_pos, gseg_start, g_last = ctx.saved_tensors
        g = _segsum_last(dcm.t(), gsort_pos, gseg_start, g_last, ctx.max_dup)
        gT = rows_to_channels(g)                          # (16, N)
        return (gT[0], gT[1], gT[2], gT[3], gT[4], gT[5], gT[6:9].t(), gT[9],
                None, None, None, None, None)


def pack_features_slab(u, v, ca, cb, cc, opacity, rgb, depth, gauss_of_pos,
                       gsort_pos, gseg_start, g_last,
                       max_dup: int) -> torch.Tensor:
    """Gather per-Gaussian channels into the (16, entry_capacity) slab
    layout. The backward reduces per-position gradients per Gaussian
    (_segsum_last), relayouts the (N, 16) result to channel-major ONCE
    (rows_to_channels, kernel 3) and returns contiguous channel slices."""
    return _PackFeaturesSlab.apply(u, v, ca, cb, cc, opacity, rgb, depth,
                                   gauss_of_pos, gsort_pos, gseg_start,
                                   g_last, max_dup)


def pack_features(mean2d, conic, opacity, rgb, depth,
                  index_matrix: torch.Tensor) -> torch.Tensor:
    """Dense (T, K, 16) gather for the oracle path. index_select, not
    advanced indexing: its backward (index_add_) sums in a fixed order on
    the CPU, where advanced indexing's scatter-add changes from run to run."""
    feats_full = _stack_features_ch(
        mean2d[:, 0], mean2d[:, 1], conic[:, 0], conic[:, 1], conic[:, 2],
        opacity, rgb[:, 0], rgb[:, 1], rgb[:, 2], depth)
    idx = index_matrix.to(torch.int64)
    return feats_full.index_select(0, idx.reshape(-1)).reshape(*idx.shape, FEAT_ROWS)
