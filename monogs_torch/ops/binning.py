"""Tile binning: per-tile, depth-sorted Gaussian slabs (port of
monogs_tpu/ops/binning.py).

Every visible Gaussian covers a rectangle of tiles and is duplicated into up
to `max_dup` (tile, depth, idx) entries after an exact peak-alpha cull; one
stable sort on an int32 key [tile_id | top DEPTH_BITS of the IEEE depth]
groups the entries per tile front to back; the sorted entries are laid out
as contiguous per-tile segments, each padded to a multiple of SLAB. The
rasterizer kernels walk a tile's segment from `pstart_blk[t] * SLAB`.

`tile_bin` runs the plain twin `_tile_bin_plain` on CPU tensors and the
hand-written kernels (csrc/binning.cu, via ops/kernels.py) on CUDA
tensors: the twin sorts and scans every one of the N * max_dup slots, the
kernels only the live entries, and every field comes out bit for bit the
same. The twin's `TileBins` are integer-identical to the JAX package's: the
sorts are stable (`torch.sort(stable=True)`, as `jax.lax.sort` is),
searchsorted keeps each call's side, and the depth bitcast is
`.view(torch.int32)`. Binning carries no gradient: it runs on detached
tensors. Every `tile_bin` is a `bin` span (utils/profiling.py), whoever
calls it, and counts its live entries and its slab rows at its path.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..utils.profiling import count, span

ALPHA_EPS = 1.0 / 255.0  # rasterizer alpha floor (shared with tile_raster)
DEPTH_BITS = 20          # key bits for depth below the tile id
CHUNK = 128              # compositing slots per inner step
BLOCK_CHUNKS = 4         # CHUNKs per slab block
SLAB = BLOCK_CHUNKS * CHUNK


class TileBins(NamedTuple):
    index_matrix: torch.Tensor   # (T, K) int32, sentinel N when empty
    counts: torch.Tensor         # (T,) int32 entries per tile (capped)
    pstart_blk: torch.Tensor     # (T,) int32 first SLAB block of the tile
    owner_blk: torch.Tensor      # (E_cap/SLAB,) int32 owning tile, sentinel T
    seg_first: torch.Tensor      # (E_cap/SLAB,) int32 1 where the owner changes
    gauss_of_pos: torch.Tensor   # (E_cap,) int32 gaussian per slab position
    gsort_pos: torch.Tensor      # (E_cap,) int32 slab positions by gaussian
    gseg_start: torch.Tensor     # (E_cap,) int32 1 at each gaussian's group
    g_last: torch.Tensor         # (N,) int32 last gsort index, sentinel E_cap
    overflow: torch.Tensor       # () int32 dropped entries (all caps)
    overflow_parts: torch.Tensor  # (4,) int32: [coverage > max_dup_gen,
                                 #   survivors > max_dup, tile > capacity,
                                 #   slab truncation at entry_capacity]


def auto_entry_capacity(n: int, max_dup: int, num_tiles: int,
                        tile_capacity: int) -> int:
    """Smallest safe (no-drop) slab capacity, SLAB-rounded."""
    k_pad = -(-tile_capacity // SLAB) * SLAB
    worst = min(n * max_dup + num_tiles * (SLAB - 1), num_tiles * k_pad)
    return -(-worst // SLAB) * SLAB


def _tile_candidates(u, v, radius, valid, opacity, conic,
                     tiles_x, tiles_y, T, tile_size, max_dup, max_dup_gen,
                     cull_alpha=ALPHA_EPS):
    """Candidate (tile, gaussian) entries: rectangle coverage, exact
    peak-alpha corner cull, survivor compaction to max_dup columns.

    Returns (tile_id (N, max_dup) with sentinel T, dup_valid, n_cover,
    surv_gen, D_gen)."""
    i32 = torch.int32
    x0 = torch.clamp(torch.floor((u - radius) / tile_size), 0, tiles_x).to(i32)
    x1 = torch.clamp(torch.ceil((u + radius + 1) / tile_size), 0, tiles_x).to(i32)
    y0 = torch.clamp(torch.floor((v - radius) / tile_size), 0, tiles_y).to(i32)
    y1 = torch.clamp(torch.ceil((v + radius + 1) / tile_size), 0, tiles_y).to(i32)
    zero = torch.zeros_like(x0)
    w = torch.where(valid, x1 - x0, zero)
    h = torch.where(valid, y1 - y0, zero)
    n_cover = w * h

    D_gen = max_dup if max_dup_gen is None else max(max_dup_gen, max_dup)
    d = torch.arange(D_gen, dtype=i32, device=u.device)[None, :]
    w_safe = torch.clamp_min(w, 1)[:, None]
    tx = x0[:, None] + d % w_safe
    ty = y0[:, None] + d // w_safe
    dup_valid = d < n_cover[:, None]

    if opacity is not None and conic is not None:
        # A candidate tile whose peak alpha over the tile rectangle stays
        # below the cull threshold contributes nothing; the power is concave,
        # so its max is 0 with the mean inside, else the max over the 4 edges.
        c0, c1, c2 = conic
        ca = torch.clamp_min(c0, 1e-12)[:, None]
        cb = c1[:, None]
        cc = torch.clamp_min(c2, 1e-12)[:, None]
        lx = tx.to(torch.float32) * tile_size - u[:, None]
        hx = lx + tile_size
        ly = ty.to(torch.float32) * tile_size - v[:, None]
        hy = ly + tile_size

        def pw(X, Y):
            return -0.5 * (ca * X * X + cc * Y * Y) - cb * X * Y

        def edge_x(X):
            return pw(X, torch.clamp(-cb * X / cc, ly, hy))

        def edge_y(Y):
            return pw(torch.clamp(-cb * Y / ca, lx, hx), Y)

        inside = (lx <= 0) & (0 <= hx) & (ly <= 0) & (0 <= hy)
        pmax = torch.maximum(torch.maximum(edge_x(lx), edge_x(hx)),
                             torch.maximum(edge_y(ly), edge_y(hy)))
        pmax = torch.where(inside, torch.zeros_like(pmax), pmax)
        peak = opacity[:, None] * torch.exp(pmax)
        dup_valid = dup_valid & (peak >= cull_alpha)
    tile_id = torch.where(dup_valid, ty * tiles_x + tx,
                          torch.full_like(tx, T)).to(i32)
    surv_gen = dup_valid.sum(1, dtype=i32)
    if D_gen > max_dup:
        # Dead candidates carry the sentinel T, so an ascending row sort
        # pushes them past the kept window.
        tile_id = torch.sort(tile_id, dim=1).values[:, :max_dup]
        dup_valid = tile_id < T
    return tile_id, dup_valid, n_cover, surv_gen, D_gen


@torch.no_grad()
def measure_entry_demand(u, v, radius, valid, opacity, conic, img_w: int,
                         img_h: int, tile_size: int, tile_capacity: int,
                         max_dup: int, max_dup_gen: int | None = None,
                         cull_alpha: float = ALPHA_EPS):
    """Occupancy probe: the SLAB-padded slab size the scene needs (sum over
    tiles of ceil(min(count, K) / SLAB) * SLAB) and the live survivor
    count, without building the slab. -> two () int32 tensors."""
    if conic is not None and not isinstance(conic, tuple):
        conic = (conic[:, 0], conic[:, 1], conic[:, 2])
    tiles_x = -(-img_w // tile_size)
    tiles_y = -(-img_h // tile_size)
    T = tiles_x * tiles_y
    tile_id, _, _, _, _ = _tile_candidates(
        u.detach(), v.detach(), radius.detach(), valid, opacity, conic,
        tiles_x, tiles_y, T, tile_size, max_dup, max_dup_gen, cull_alpha)
    sort_tile = torch.sort(tile_id.reshape(-1)).values
    starts = torch.searchsorted(
        sort_tile, torch.arange(T + 1, dtype=torch.int32, device=u.device))
    seg_counts = torch.clamp_max(starts[1:] - starts[:-1], tile_capacity)
    padded = (-(-seg_counts // SLAB) * SLAB).sum()
    return padded.to(torch.int32), seg_counts.sum().to(torch.int32)


@torch.no_grad()
def tile_bin(
    mean2d,                   # (N, 2) pixel coords, or None with uv=
    radius: torch.Tensor,     # (N,) screen radius (0 => culled)
    depth: torch.Tensor,      # (N,)
    valid: torch.Tensor,      # (N,) bool
    img_w: int,
    img_h: int,
    tile_size: int = 16,
    tile_capacity: int = 512,
    max_dup: int = 16,
    entry_capacity: int | None = None,
    opacity: torch.Tensor | None = None,  # (N,) activated; enables the cull
    conic=None,                           # (N, 3) or ((N,),) * 3
    uv=None,                              # ((N,), (N,)) alternative to mean2d
    max_dup_gen: int | None = None,       # candidate width before the cull
    cull_alpha: float = ALPHA_EPS,
) -> TileBins:
    if uv is not None:
        u, v = uv
    else:
        u, v = mean2d[:, 0], mean2d[:, 1]
    if conic is not None and not isinstance(conic, tuple):
        conic = (conic[:, 0], conic[:, 1], conic[:, 2])
    u, v, radius, depth = (x.detach() for x in (u, v, radius, depth))
    if opacity is not None:
        opacity = opacity.detach()
        conic = tuple(c.detach() for c in conic)
    dev = u.device
    N = u.shape[0]
    tiles_x = -(-img_w // tile_size)
    tiles_y = -(-img_h // tile_size)
    T = tiles_x * tiles_y
    K = tile_capacity
    if T >= (1 << (31 - DEPTH_BITS)):
        raise ValueError("too many tiles for the packed sort key")
    if K % CHUNK:
        raise ValueError("tile_capacity must be a multiple of CHUNK")
    if entry_capacity is None:
        entry_capacity = auto_entry_capacity(N, max_dup, T, K)
    if entry_capacity % SLAB or entry_capacity < SLAB:
        raise ValueError("entry_capacity must be a positive multiple of SLAB")
    P_cap = entry_capacity

    with span("bin", device=dev) as sp:
        if dev.type == "cpu":
            bins = _tile_bin_plain(u, v, radius, depth, valid, opacity, conic, tiles_x,
                                   tiles_y, tile_size, K, max_dup, max_dup_gen, P_cap,
                                   cull_alpha)
        else:
            from . import kernels

            # The twin culls only with both the opacity and the conic.
            if opacity is not None and conic is not None:
                opacity, conic = opacity.contiguous(), tuple(c.contiguous() for c in conic)
            else:
                opacity = conic = None
            bins = kernels.tile_bin(
                u.contiguous(), v.contiguous(), radius.contiguous(), depth.contiguous(),
                valid.contiguous(), opacity, conic, tiles_x=tiles_x, tiles_y=tiles_y,
                tile_size=tile_size, K=K, max_dup=max_dup, max_dup_gen=max_dup_gen,
                P_cap=P_cap, cull_alpha=cull_alpha)
    # How full the slab is, summed on the device (two launches), at the
    # span's path but outside it, so the span times the binning alone.
    count("slab_live", bins.counts.sum(), at=sp)
    count("slab_rows", P_cap, at=sp)
    return bins


@torch.no_grad()
def _tile_bin_plain(u, v, radius, depth, valid, opacity, conic, tiles_x: int,
                    tiles_y: int, tile_size: int, K: int, max_dup: int,
                    max_dup_gen: int | None, P_cap: int, cull_alpha: float) -> TileBins:
    """tile_bin's plain PyTorch twin, the path of CPU tensors: every one of
    the N * max_dup slots is sorted and scanned, live or not. The kernels
    (csrc/binning.cu) give every field bit for bit as this does on the
    card."""
    dev = u.device
    i32, i64 = torch.int32, torch.int64
    N = u.shape[0]
    T = tiles_x * tiles_y
    EB = P_cap // SLAB

    tile_id, dup_valid, n_cover, surv_gen, D_gen = _tile_candidates(
        u, v, radius, valid, opacity, conic,
        tiles_x, tiles_y, T, tile_size, max_dup, max_dup_gen, cull_alpha,
    )
    # Packed key [tile_id | depth bits]: positive-float IEEE bits are
    # monotonic, so clamp to >= 0 before the bitcast.
    depth_bits = (torch.clamp_min(depth, 0.0).to(torch.float32)
                  .view(i32) >> (31 - DEPTH_BITS))
    key = (tile_id << DEPTH_BITS) | depth_bits[:, None]
    key = torch.where(dup_valid, key, torch.full_like(key, T << DEPTH_BITS))

    E = N * max_dup
    flat_idx = torch.arange(N, dtype=i32, device=dev)[:, None].expand(
        N, max_dup).reshape(-1)
    sort_key, sort_entry = torch.sort(key.reshape(-1), stable=True)
    sort_idx = flat_idx[sort_entry]
    sort_tile = sort_key >> DEPTH_BITS

    # Per-tile segments of the sorted entry list (left searchsorted).
    starts = torch.searchsorted(
        sort_tile, torch.arange(T + 1, dtype=i32, device=dev)).to(i64)
    seg_counts = starts[1:] - starts[:-1]
    counts = torch.clamp_max(seg_counts, K)

    # SLAB-padded layout, truncated at the entry capacity.
    nblk0 = (counts + SLAB - 1) // SLAB
    pstart0 = torch.cumsum(nblk0, 0) - nblk0
    nblk = torch.minimum(nblk0, torch.clamp_min(EB - pstart0, 0))
    counts_eff = torch.minimum(counts, nblk * SLAB)
    cum = torch.cumsum(nblk, 0)
    pstart_blk = cum - nblk

    # (T, K) index matrix, for the n_touched aggregation.
    k = torch.arange(K, dtype=i64, device=dev)[None, :]
    gather_pos_tk = starts[:-1, None] + k
    in_range = k < counts_eff[:, None]
    n_fill = torch.full((), N, dtype=i32, device=dev)
    index_matrix = torch.where(
        in_range,
        sort_idx[torch.where(in_range, gather_pos_tk, torch.zeros_like(k))],
        n_fill)

    b = torch.arange(EB, dtype=i64, device=dev)
    owner_blk = torch.searchsorted(cum, b, right=True)
    seg_first = torch.cat([torch.ones(1, dtype=i64, device=dev),
                           (owner_blk[1:] != owner_blk[:-1]).to(i64)])
    owner_safe = torch.clamp_max(owner_blk, T - 1)

    def rep(a):
        return a[:, None].expand(EB, SLAB).reshape(-1)

    p = torch.arange(EB * SLAB, dtype=i64, device=dev)
    k_p = p - rep(pstart_blk[owner_safe]) * SLAB
    ok_p = (rep(owner_blk) < T) & (k_p < rep(counts_eff[owner_safe]))
    j_p = torch.clamp(rep(starts[owner_safe]) + k_p, 0, E - 1)
    gauss_of_pos = torch.where(ok_p, sort_idx[j_p], n_fill)

    # Slab position of each sorted entry from segment-boundary scans.
    j = torch.arange(E, dtype=i64, device=dev)
    boundary = torch.cat([torch.ones(1, dtype=torch.bool, device=dev),
                          sort_tile[1:] != sort_tile[:-1]])
    seg_start = torch.cummax(torch.where(boundary, j, torch.zeros_like(j)),
                             0).values
    k_j = j - seg_start
    prev_start = torch.cat([torch.zeros(1, dtype=i64, device=dev),
                            seg_start[:-1]])
    prev_kept = torch.clamp_max(j - prev_start, K)
    prev_pad = torch.where(boundary & (j > 0), -(-prev_kept // SLAB) * SLAB,
                           torch.zeros_like(j))
    pos = torch.cumsum(prev_pad, 0) + k_j
    pos_sorted = torch.where((sort_tile < T) & (k_j < K) & (pos < P_cap), pos,
                             torch.full_like(pos, P_cap))
    # sort_entry is a permutation, so this scatter un-permutes exactly (the
    # JAX package sorts (entry, pos) pairs by entry id instead).
    pos_of_entry = torch.empty_like(pos_sorted)
    pos_of_entry[sort_entry.to(i64)] = pos_sorted

    # Gaussian-sorted slab view for the segmented-scan gather backward.
    surv = (pos_of_entry < P_cap).reshape(N, max_dup)
    k_i = surv.sum(1)
    incl = torch.cumsum(k_i, 0)
    excl = incl - k_i
    g_last = torch.where(k_i > 0, incl - 1, torch.full_like(incl, P_cap))
    rank = torch.cumsum(surv.to(i64), 1) - 1
    gpos = excl[:, None] + rank
    dest = torch.where(surv, gpos, torch.full_like(gpos, E)).reshape(-1)
    gauss_e = torch.arange(N, dtype=i64, device=dev)[:, None].expand(N, max_dup)
    gauss_val = torch.where(surv, gauss_e,
                            torch.full_like(gauss_e, N)).reshape(-1)
    order = torch.sort(dest, stable=True).indices
    gsort_pos = torch.clamp_max(pos_of_entry, P_cap - 1)[order]
    gsort_gauss = gauss_val[order]
    if E < P_cap:
        gsort_pos = torch.cat([gsort_pos, torch.full(
            (P_cap - E,), P_cap - 1, dtype=i64, device=dev)])
        gsort_gauss = torch.cat([gsort_gauss, torch.full(
            (P_cap - E,), N, dtype=i64, device=dev)])
    else:
        gsort_pos = gsort_pos[:P_cap]
        gsort_gauss = gsort_gauss[:P_cap]
    gseg_start = torch.cat([torch.ones(1, dtype=i64, device=dev),
                            (gsort_gauss[1:] != gsort_gauss[:-1]).to(i64)])

    overflow_parts = torch.stack([
        torch.clamp_min(n_cover - D_gen, 0).sum(),
        torch.clamp_min(surv_gen - max_dup, 0).sum(),
        torch.clamp_min(seg_counts - K, 0).sum(),
        (counts - counts_eff).sum(),
    ]).to(i32)
    return TileBins(
        index_matrix=index_matrix.to(i32), counts=counts_eff.to(i32),
        pstart_blk=pstart_blk.to(i32), owner_blk=owner_blk.to(i32),
        seg_first=seg_first.to(i32), gauss_of_pos=gauss_of_pos.to(i32),
        gsort_pos=gsort_pos.to(i32), gseg_start=gseg_start.to(i32),
        g_last=g_last.to(i32), overflow=overflow_parts.sum().to(i32),
        overflow_parts=overflow_parts)
