"""Differentiable render op (port of monogs_tpu/ops/render.py).

Pipeline: project_gaussians (autograd, pose delta included) -> tile_bin
(integer slab layout, no gradient) -> pack_features_slab (gather with the
segmented-scan backward) -> composite_slab (the CUDA kernels) -> assemble.
`render_window` renders the mapper's whole keyframe window with ONE launch
of each slab kernel: every keyframe's slab is a slice of one
(Wn, 16, E_cap) array and the tile and block ids are global.

backend="slab" is the production path: on a CUDA tensor it launches the
Hopper kernels, on a CPU tensor it runs their plain twins. backend="ref" is
the dense autograd oracle (composite_tiles_ref).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .binning import ALPHA_EPS, SLAB, TileBins, tile_bin
from .graphics import Intrinsics
from .projection import ProjectedChannels, project_gaussians, project_gaussians_ch
from .tile_raster import (
    RasterConfig,
    composite_slab,
    composite_tiles_ref,
    make_raster_config,
    pack_features,
    pack_features_slab,
    pack_features_window,
)


class RenderOutput(NamedTuple):
    rgb: torch.Tensor        # (H, W, 3)
    depth: torch.Tensor      # (H, W) alpha-blended depth
    opacity: torch.Tensor    # (H, W) accumulated alpha
    n_touched: torch.Tensor  # (N,) int32 per-Gaussian contributing-pixel count
    radii: torch.Tensor      # (N,) float screen radius (0 = culled)
    overflow: torch.Tensor   # () int32 binning-capacity diagnostics
    overflow_parts: torch.Tensor  # (4,) int32 (see binning.TileBins)


def _assemble_image(out: torch.Tensor, cfg: RasterConfig) -> torch.Tensor:
    """(..., T, P, C) tile buffers -> (..., H, W, C) images (cropped)."""
    ts, C, lead = cfg.tile_size, out.shape[-1], out.shape[:-3]
    img = out.reshape(*lead, cfg.tiles_y, cfg.tiles_x, ts, ts, C)
    img = img.transpose(-4, -3).reshape(*lead, cfg.tiles_y * ts,
                                        cfg.tiles_x * ts, C)
    return img[..., : cfg.img_h, : cfg.img_w, :]


def tile_image(img: torch.Tensor, cfg: RasterConfig) -> torch.Tensor:
    """(H, W[, C]) image -> (T, P[, C]) tile layout (_assemble_image's
    inverse; out-of-image pixels zero / False)."""
    ts = cfg.tile_size
    squeeze = img.dim() == 2
    if squeeze:
        img = img[..., None]
    H, W, C = img.shape
    padded = img.new_zeros((cfg.tiles_y * ts, cfg.tiles_x * ts, C))
    padded[:H, :W] = img
    tiles = padded.reshape(cfg.tiles_y, ts, cfg.tiles_x, ts, C).permute(
        0, 2, 1, 3, 4).reshape(cfg.num_tiles, cfg.pixels, C)
    return tiles[..., 0] if squeeze else tiles


def render_projected(
    proj,                                # ProjectedGaussians | ProjectedChannels
    cfg: RasterConfig,
    *,
    rgbs: torch.Tensor | None = None,    # (N, 3); required with ProjectedChannels
    bg: torch.Tensor | None = None,
    tile_capacity: int = 512,
    max_dup: int = 16,
    max_dup_gen: int | None = None,
    entry_capacity: int | None = None,
    backend: str = "slab",
    bins=None,
    with_n_touched: bool = True,
    assemble: bool = True,
) -> RenderOutput:
    """Rasterize already-projected Gaussians.

    `bins` may be a precomputed TileBins that freezes the tile assignment
    (the tracker reuses it across iterations). with_n_touched=False skips
    the visibility count. assemble=False returns rgb/depth/opacity in tile
    layout, (T, P, 3) / (T, P), for a loss against `tile_image`d ground
    truth.
    """
    if backend not in ("slab", "ref"):
        raise ValueError(f"backend must be 'slab' or 'ref', got {backend!r}")
    if isinstance(proj, ProjectedChannels):
        if rgbs is None:
            raise ValueError("rgbs required with ProjectedChannels")
        u, v = proj.u, proj.v
        conic_ch = (proj.ca, proj.cb, proj.cc)
    else:
        rgbs = proj.rgb
        u, v = proj.mean2d[:, 0], proj.mean2d[:, 1]
        conic_ch = (proj.conic[:, 0], proj.conic[:, 1], proj.conic[:, 2])
    N = u.shape[0]
    opacity = torch.where(proj.valid, proj.opacity,
                          torch.zeros_like(proj.opacity))

    if bins is None:
        bins = tile_bin(
            None, proj.radius, proj.depth, proj.valid,
            img_w=cfg.img_w, img_h=cfg.img_h, tile_size=cfg.tile_size,
            tile_capacity=tile_capacity, max_dup=max_dup,
            max_dup_gen=max_dup_gen, entry_capacity=entry_capacity,
            opacity=opacity, conic=conic_ch, uv=(u, v),
        )

    if backend == "ref":
        feats = pack_features(torch.stack([u, v], dim=-1),
                              torch.stack(conic_ch, dim=-1), opacity, rgbs,
                              proj.depth, bins.index_matrix)   # (T, K, 16)
        out, touched = composite_tiles_ref(feats, cfg)
    else:
        feats_cm = pack_features_slab(
            u, v, *conic_ch, opacity, rgbs, proj.depth,
            bins.gauss_of_pos, bins.gsort_pos, bins.gseg_start, bins.g_last,
            max_dup,
        )                                                  # (16, E_cap)
        out, touched = composite_slab(feats_cm[None], bins.pstart_blk,
                                      bins.counts, cfg, tile_capacity,
                                      with_n_touched)

    img = _assemble_image(out, cfg) if assemble else out
    alpha = img[..., 4]
    rgb = img[..., 0:3]
    if bg is not None:
        rgb = rgb + (1.0 - alpha)[..., None] * bg

    if with_n_touched:
        n_touched = torch.zeros(N + 1, dtype=torch.int32, device=u.device)
        n_touched.index_add_(0, bins.index_matrix.reshape(-1).to(torch.int64),
                             touched.reshape(-1))
        n_touched = n_touched[:N]
    else:
        n_touched = torch.zeros(N, dtype=torch.int32, device=u.device)

    return RenderOutput(rgb=rgb, depth=img[..., 3], opacity=alpha,
                        n_touched=n_touched, radii=proj.radius,
                        overflow=bins.overflow,
                        overflow_parts=bins.overflow_parts)


def render(
    means3d: torch.Tensor,
    scales: torch.Tensor,       # activated (exp)
    quats: torch.Tensor,
    opacities: torch.Tensor,    # activated (sigmoid), (N,)
    rgbs: torch.Tensor,
    R_w2c: torch.Tensor,
    t_w2c: torch.Tensor,
    intr: Intrinsics,
    *,
    rho: torch.Tensor | None = None,
    theta: torch.Tensor | None = None,
    active: torch.Tensor | None = None,
    bg: torch.Tensor | None = None,
    tile_size: int = 16,
    tile_capacity: int = 512,
    max_dup: int = 16,
    max_dup_gen: int | None = None,
    entry_capacity: int | None = None,
    backend: str = "slab",
    bins=None,
    with_n_touched: bool = True,
) -> RenderOutput:
    """Full differentiable render on the device of `means3d`; rho / theta
    are the se(3) camera-pose deltas (default zero)."""
    z3 = means3d.new_zeros(3)
    cfg = make_raster_config(intr.width, intr.height, tile_size)
    proj = project_gaussians(
        means3d, scales, quats, opacities, rgbs, R_w2c, t_w2c,
        z3 if rho is None else rho, z3 if theta is None else theta, intr,
        active=active,
    )
    return render_projected(
        proj, cfg, bg=bg, tile_capacity=tile_capacity, max_dup=max_dup,
        max_dup_gen=max_dup_gen, entry_capacity=entry_capacity,
        backend=backend, bins=bins, with_n_touched=with_n_touched,
    )


class WindowRenderOutput(NamedTuple):
    rgb: torch.Tensor        # (Wn, H, W, 3), or (Wn, T, P, 3) unassembled
    depth: torch.Tensor      # (Wn, H, W)
    opacity: torch.Tensor    # (Wn, H, W)
    n_touched: torch.Tensor  # (Wn, N) int32
    radii: torch.Tensor      # (Wn, N)
    overflow: torch.Tensor   # () int32 summed over the window
    overflow_parts: torch.Tensor  # (4,) int32 summed over the window


def bin_window(u, v, radius, depth, valid, opacity, conic, cfg: RasterConfig,
               *, tile_capacity: int, max_dup: int, max_dup_gen: int | None,
               entry_capacity: int | None,
               cull_alpha: float = ALPHA_EPS) -> TileBins:
    """tile_bin of every keyframe of a window: (Wn, N) channels (conic a
    tuple of three) -> TileBins with a leading window axis. One binning per
    keyframe; all stay on the device."""
    bins = [tile_bin(
        None, radius[w], depth[w], valid[w], img_w=cfg.img_w, img_h=cfg.img_h,
        tile_size=cfg.tile_size, tile_capacity=tile_capacity, max_dup=max_dup,
        max_dup_gen=max_dup_gen, entry_capacity=entry_capacity,
        opacity=opacity[w], conic=tuple(c[w] for c in conic), uv=(u[w], v[w]),
        cull_alpha=cull_alpha) for w in range(u.shape[0])]
    return TileBins(*(torch.stack(f) for f in zip(*bins)))


def project_window(means3d, scales, quats, opacities, Rs, ts, rhos, thetas,
                   intr: Intrinsics, active=None) -> ProjectedChannels:
    """project_gaussians_ch for every keyframe at once: (Wn, 3, 3) / (Wn, 3)
    poses and deltas -> ProjectedChannels of (Wn, N) tensors."""
    return torch.vmap(lambda R, t, rho, theta: project_gaussians_ch(
        means3d, scales, quats, opacities, R, t, rho, theta, intr,
        active=active))(Rs, ts, rhos, thetas)


def render_window(
    means3d: torch.Tensor,
    scales: torch.Tensor,
    quats: torch.Tensor,
    opacities: torch.Tensor,
    rgbs: torch.Tensor,
    Rs: torch.Tensor,            # (Wn, 3, 3) per-keyframe w2c
    ts: torch.Tensor,            # (Wn, 3)
    intr: Intrinsics,
    *,
    rhos: torch.Tensor,          # (Wn, 3) per-keyframe se(3) deltas
    thetas: torch.Tensor,        # (Wn, 3)
    active: torch.Tensor | None = None,
    bg: torch.Tensor | None = None,
    tile_size: int = 16,
    tile_capacity: int = 512,
    max_dup: int = 16,
    max_dup_gen: int | None = None,
    entry_capacity: int | None = None,
    backend: str = "slab",
    mean2d_dummy=None,           # (Wn, N, 2) or a ((Wn, N), (Wn, N)) pair
    bins: TileBins | None = None,  # leading window axis; frozen assignment
    with_n_touched: bool = True,
    assemble: bool = True,
) -> WindowRenderOutput:
    """Batched multi-view render: the mapper's whole keyframe window in ONE
    launch of each slab kernel.

    The (du, dv) `mean2d_dummy` pair is added to the projected means; its
    gradient is the screen-space gradient that densification reads.
    assemble=False returns rgb / depth / opacity in tile layout, (Wn, T, P,
    3) / (Wn, T, P), for a loss against `tile_image`d ground truth.
    """
    if backend not in ("slab", "ref"):
        raise ValueError(f"backend must be 'slab' or 'ref', got {backend!r}")
    Wn, N = Rs.shape[0], means3d.shape[0]
    cfg = make_raster_config(intr.width, intr.height, tile_size)
    proj = project_window(means3d, scales, quats, opacities, Rs, ts, rhos,
                          thetas, intr, active=active)
    u, v = proj.u, proj.v
    if isinstance(mean2d_dummy, tuple):
        u, v = u + mean2d_dummy[0], v + mean2d_dummy[1]
    elif mean2d_dummy is not None:
        u, v = u + mean2d_dummy[..., 0], v + mean2d_dummy[..., 1]
    conic_ch = (proj.ca, proj.cb, proj.cc)
    opa = torch.where(proj.valid, proj.opacity, torch.zeros_like(proj.opacity))
    if bins is None:
        bins = bin_window(u, v, proj.radius, proj.depth, proj.valid, opa,
                          conic_ch, cfg, tile_capacity=tile_capacity,
                          max_dup=max_dup, max_dup_gen=max_dup_gen,
                          entry_capacity=entry_capacity)
    T, K = bins.index_matrix.shape[1:]

    if backend == "ref":
        feats = torch.cat([pack_features(
            torch.stack([u[w], v[w]], dim=-1),
            torch.stack([c[w] for c in conic_ch], dim=-1), opa[w], rgbs,
            proj.depth[w], bins.index_matrix[w]) for w in range(Wn)])
        out, touched = composite_tiles_ref(feats, cfg)
    else:
        feats = pack_features_window(
            u, v, *conic_ch, opa, proj.depth, rgbs[:, 0], rgbs[:, 1],
            rgbs[:, 2], bins.gauss_of_pos, bins.gsort_pos, bins.gseg_start,
            bins.g_last, max_dup)                        # (Wn, 16, E_cap)
        img = torch.arange(Wn, dtype=torch.int32, device=u.device)[:, None]
        pstart_g = (bins.pstart_blk + img * (feats.shape[2] // SLAB)).reshape(-1)
        out, touched = composite_slab(feats, pstart_g, bins.counts.reshape(-1),
                                      cfg, tile_capacity, with_n_touched)

    out = out.reshape(Wn, T, cfg.pixels, 8)
    imgs = _assemble_image(out, cfg) if assemble else out
    alpha = imgs[..., 4]
    rgb = imgs[..., 0:3]
    if bg is not None:
        rgb = rgb + (1.0 - alpha)[..., None] * bg

    if with_n_touched:
        # One index_add_ over the window: keyframe w's ids are offset by
        # w (N + 1), so every keyframe keeps its own sentinel slot N.
        off = torch.arange(Wn, device=u.device)[:, None, None] * (N + 1)
        n_touched = torch.zeros(Wn * (N + 1), dtype=torch.int32, device=u.device)
        n_touched.index_add_(0, (bins.index_matrix.to(torch.int64) + off).reshape(-1),
                             touched.reshape(-1))
        n_touched = n_touched.reshape(Wn, N + 1)[:, :N]
    else:
        n_touched = torch.zeros((Wn, N), dtype=torch.int32, device=u.device)

    return WindowRenderOutput(
        rgb=rgb, depth=imgs[..., 3], opacity=alpha, n_touched=n_touched,
        radii=proj.radius, overflow=bins.overflow.sum().to(torch.int32),
        overflow_parts=bins.overflow_parts.sum(0).to(torch.int32))
