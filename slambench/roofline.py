"""The work of a slab compositing launch, counted from its inputs by the
reference's semantics, and the H100's published peaks.

A launch composites, for every tile, the tile's entries front to back
into each pixel of the tile. By the reference's semantics (3D Gaussian
splatting's rasterizer) a pixel evaluates alpha for every entry until its
transmittance has fallen below 1e-4, and does the rest of the arithmetic
only for the entries whose alpha passes the 1/255 test. So a launch is
charged ALPHA_OPS on every (pixel, entry) pair up to the entry at which the
pixel's transmittance falls below the cut-off, and FWD_REST_OPS (forward)
or BWD_REST_OPS (backward) on the pairs among them whose alpha passes. How
a kernel walks the pairs (chunks, warps, votes) charges nothing: another
implementation of the same launch is charged the same work.

float32 operations per pair, each exp or divide one operation and a
multiply-add two, as the peak counts them:
  alpha:    dx, dy 2; power 9; clamp, exp 2; alpha_raw, tests, min 4 = 17
  forward:  w = alpha T 1; four colour sums and the alpha sum 9;
            1 - alpha and the T product 2                               = 12
  backward: w 1; the pixel's summed gradient g 8; the suffix sum S 2;
            1 - alpha, divide, dalpha 4; mask and dpower 3; dx, dy
            terms 2; the conic's and the mean's moments 8; w g per
            channel 8; the T product 1; the entry's 10 gradient sums 10  = 47
Bytes: each input read once and each output written once: the 10 used
feature rows of every listed entry, the per-tile starts and counts, and the
(tiles, pixels, 8) image (forward) or the (tiles, 8, pixels) pixel
gradients and the entries' 10 gradient rows (backward).
"""

from __future__ import annotations

import torch

# NVIDIA H100 SXM data sheet, dense, 700 W.
PEAK_FP32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12

ALPHA_OPS, FWD_REST_OPS, BWD_REST_OPS = 17, 12, 47
T_CUTOFF = 1e-4
ALPHA_MIN = 1.0 / 255.0
ALPHA_MAX = 0.99
USED_ROWS = 10
BLOCK_PAIRS = 1 << 25


@torch.no_grad()
def count_pairs(feats_cm, pstart_blk, counts, tile_size: int, tiles_x: int,
                num_tiles: int, img_w: int, img_h: int, slab: int):
    """(pairs charged alpha, pairs whose alpha passes) of one launch.

    feats_cm (n_img, 16, E) channel-major entries: rows u, v, conic a, b, c,
    opacity, ...; tile t's entries are columns pstart_blk[t] * slab ..
    + counts[t] of the images' slabs laid end to end; tile t's origin is
    that of tile t % num_tiles of an image."""
    dev = feats_cm.device
    flat = feats_cm.permute(1, 0, 2).reshape(feats_cm.shape[1], -1)[:6].float()
    base = pstart_blk.long() * slab
    cnt = counts.long()
    P = tile_size * tile_size
    p = torch.arange(P, device=dev)
    lx, ly = (p % tile_size).float() + 0.5, (p // tile_size).float() + 0.5
    n_alpha = torch.zeros((), dtype=torch.int64, device=dev)
    n_pass = torch.zeros((), dtype=torch.int64, device=dev)
    order = torch.argsort(cnt)
    cl = cnt[order].tolist()
    i = 0
    while i < len(cl):
        j = i + 1
        while j < len(cl) and (j - i + 1) * P * max(cl[j], 1) <= BLOCK_PAIRS:
            j += 1
        k = max(cl[j - 1], 1)
        tiles = order[i:j]
        i = j
        kk = torch.arange(k, device=dev)
        live = kk[None, :] < cnt[tiles, None]
        col = torch.where(live, base[tiles, None] + kk[None, :], torch.zeros_like(kk[None, :]))
        f = flat[:, col]                                   # (6, Tb, k)
        tid = tiles % num_tiles
        ox = ((tid % tiles_x) * tile_size).float()
        oy = ((tid // tiles_x) * tile_size).float()
        dx = (ox[:, None] + lx[None, :])[:, :, None] - f[0][:, None, :]
        dy = (oy[:, None] + ly[None, :])[:, :, None] - f[1][:, None, :]
        power = -0.5 * (f[2][:, None] * dx * dx + f[4][:, None] * dy * dy) - f[3][:, None] * dx * dy
        a_raw = f[5][:, None] * torch.exp(torch.clamp_max(power, 0.0))
        ok = (power <= 0) & (a_raw >= ALPHA_MIN) & live[:, None, :]
        alpha = torch.where(ok, torch.clamp_max(a_raw, ALPHA_MAX), torch.zeros_like(a_raw))
        trans = torch.cumprod(1.0 - alpha, -1)
        before = torch.cat([torch.ones_like(trans[..., :1]), trans[..., :-1]], -1)
        in_img = ((ox[:, None] + lx[None, :] < img_w) & (oy[:, None] + ly[None, :] < img_h))
        charged = (before >= T_CUTOFF) & live[:, None, :] & in_img[:, :, None]
        n_alpha += charged.sum()
        n_pass += (charged & ok).sum()
    return int(n_alpha), int(n_pass)


def launch_work(kind: str, feats_cm, pstart_blk, counts, cfg, slab: int,
                emit_touched: bool = False, K: int = 0):
    """(float32 operations, bytes) of one slab_fwd or slab_bwd launch."""
    n_alpha, n_pass = count_pairs(feats_cm, pstart_blk, counts, cfg.tile_size, cfg.tiles_x,
                                  cfg.num_tiles, cfg.img_w, cfg.img_h, slab)
    entries = int(counts.long().sum())
    Tt, P = counts.shape[0], cfg.tile_size * cfg.tile_size
    tables = 2 * 4 * Tt
    if kind == "slab_fwd":
        ops = ALPHA_OPS * n_alpha + FWD_REST_OPS * n_pass
        nbytes = 4 * USED_ROWS * entries + tables + 4 * 8 * Tt * P
        if emit_touched:
            nbytes += 4 * Tt * K
    else:
        ops = ALPHA_OPS * n_alpha + BWD_REST_OPS * n_pass
        nbytes = 2 * 4 * USED_ROWS * entries + tables + 4 * 8 * Tt * P
    return ops, nbytes


def ideal_seconds(ops: float, nbytes: float) -> float:
    """The least time the H100 could take: the larger of the operations at
    the float32 peak and the bytes at the HBM peak."""
    return max(ops / PEAK_FP32_FLOPS, nbytes / PEAK_HBM_BYTES)
