"""Tracker: per-frame camera-pose optimisation (port of
monogs_tpu/slam/tracker.py).

Adam over the se(3) pose delta (rho, theta) and the exposure affine (a, b),
rendering through the differentiable rasterizer each iteration, retracting
T_w2c <- SE3_exp([rho, theta]) @ T_w2c and re-zeroing the deltas, with a
convergence exit at ||tau|| < threshold. The tile bins are frozen for
`rebin_every` iterations at a time, as in the JAX loop.

Host syncs: the JAX loop is one `while_loop` with no host round trip. Here
the loop is Python, so the convergence exit reads a device bool once per
iteration (a device-to-host sync, counted by `profiling.host_read`). With
convergence_threshold <= 0 the exit cannot fire and the read is skipped,
which changes no result. While a torch profiler records, each iteration is
a `track.iter` span.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from ..models.gaussian_map import get_opacity, get_scales
from ..ops import lie
from ..ops.binning import tile_bin
from ..ops.graphics import Intrinsics
from ..ops.losses import get_loss_tracking, get_median_depth
from ..ops.projection import project_gaussians_ch
from ..ops.render import make_raster_config, render, render_projected, tile_image
from ..utils.profiling import fine_span, host_read
from .camera import Frame


@dataclasses.dataclass(frozen=True)
class TrackerConfig:
    """Tracking hyperparameters; the defaults are the JAX package's."""

    max_iters: int = 100
    convergence_threshold: float = 1e-4
    opacity_threshold: float = 0.99
    rebin_every: int = 8          # re-run tile binning every k iterations
    lr_rot: float = 0.003
    lr_trans: float = 0.001
    lr_exposure: float = 0.01
    adam_eps: float = 1e-8
    tile_size: int = 32
    tile_capacity: int = 2048
    max_dup: int = 4
    max_dup_gen: int | None = 16
    entry_capacity: int | None = None  # slab rows; None = safe auto
    cull_alpha: float = 1.0 / 255.0
    backend: str = "slab"         # "slab" (kernels / twins) or "ref"
    isotropic: bool = False
    exposure_reg: float = 0.0     # L2 anchor on the exposure affine
    const_velocity: bool = False  # host-side pose init knob (SLAM system loop)


class TrackResult(NamedTuple):
    R: torch.Tensor
    t: torch.Tensor
    exposure_a: torch.Tensor
    exposure_b: torch.Tensor
    n_iters: torch.Tensor         # () int32 iterations actually run
    converged: torch.Tensor       # () bool
    median_depth: torch.Tensor    # () from the final render
    visibility: torch.Tensor      # (N,) bool n_touched > 0
    render_depth: torch.Tensor    # (H, W)
    render_opacity: torch.Tensor  # (H, W)
    overflow: torch.Tensor        # () int32 binning entries dropped
    overflow_parts: torch.Tensor  # (4,) int32
    # [R.ravel() (9), t (3), exposure_a, exposure_b, n_iters, converged,
    #  median_depth, overflow, overflow_parts (4)]: one host read.
    host_stats: torch.Tensor      # (22,) float32


def unpack_host_stats(stats) -> dict:
    """Decode TrackResult.host_stats (a single (22,) host read)."""
    with host_read():
        s = stats.detach().cpu().numpy() if torch.is_tensor(stats) else np.asarray(stats)
    return {
        "R": s[0:9].reshape(3, 3),
        "t": s[9:12],
        "exposure_a": float(s[12]),
        "exposure_b": float(s[13]),
        "n_iters": int(s[14]),
        "converged": bool(s[15]),
        "median_depth": float(s[16]),
        "overflow": int(s[17]),
        "overflow_parts": [int(x) for x in s[18:22]],
    }


class _Adam4(NamedTuple):
    """Adam moments for (rho, theta, exposure_a, exposure_b)."""

    mu: tuple
    nu: tuple
    step: torch.Tensor


def _adam4_init(device) -> _Adam4:
    z3 = torch.zeros(3, device=device)
    z = torch.zeros((), device=device)
    return _Adam4(mu=(z3, z3, z, z), nu=(z3, z3, z, z),
                  step=torch.zeros((), dtype=torch.int32, device=device))


def _adam4_update(grads, st: _Adam4, lrs, eps):
    step = st.step + 1
    t = step.to(torch.float32)
    bc1 = 1.0 - 0.9 ** t
    bc2 = 1.0 - 0.999 ** t
    mu = tuple(0.9 * m + 0.1 * g for m, g in zip(st.mu, grads))
    nu = tuple(0.999 * v + 0.001 * g * g for v, g in zip(st.nu, grads))
    upd = tuple(-lr * (m / bc1) / (torch.sqrt(v / bc2) + eps)
                for m, v, lr in zip(mu, nu, lrs))
    return upd, _Adam4(mu=mu, nu=nu, step=step)


def track_frame(params: dict, active: torch.Tensor | None, frame: Frame,
                intr: Intrinsics, cfg: TrackerConfig,
                bg: torch.Tensor | None = None) -> TrackResult:
    """Optimise the pose of `frame` against the map `params` (a dict of
    tensors under xyz, log_scales, quats, opacity_logit, rgb). Runs on the
    device the inputs live on; bg None is a zero background."""
    dev = params["xyz"].device
    xyz, quats, rgbs = params["xyz"], params["quats"], params["rgb"]
    scales = get_scales(params, cfg.isotropic)
    opac = get_opacity(params)
    rcfg = make_raster_config(intr.width, intr.height, cfg.tile_size)

    # The ground truth is tiled once per frame; the loss runs in tile layout.
    gt_rgb_t = tile_image(frame.rgb, rcfg)
    gt_depth_t = tile_image(frame.depth, rcfg)
    pad_valid = tile_image(torch.ones(frame.rgb.shape[:2], dtype=torch.bool,
                                      device=dev), rcfg)
    gt_mask_t = tile_image(frame.mask, rcfg) & pad_valid
    grad_mask_t = tile_image(frame.grad_mask, rcfg) & pad_valid
    z3 = torch.zeros(3, device=dev)

    def compute_bins(R, t):
        proj = project_gaussians_ch(xyz, scales, quats, opac, R, t, z3, z3,
                                    intr, active=active)
        return tile_bin(
            None, proj.radius, proj.depth, proj.valid,
            img_w=intr.width, img_h=intr.height, tile_size=cfg.tile_size,
            tile_capacity=cfg.tile_capacity, max_dup=cfg.max_dup,
            entry_capacity=cfg.entry_capacity,
            opacity=torch.where(proj.valid, proj.opacity,
                                torch.zeros_like(proj.opacity)),
            conic=(proj.ca, proj.cb, proj.cc), uv=(proj.u, proj.v),
            max_dup_gen=cfg.max_dup_gen, cull_alpha=cfg.cull_alpha,
        )

    def loss_fn(rho, theta, ea, eb, R, t, bins):
        proj = project_gaussians_ch(xyz, scales, quats, opac, R, t, rho,
                                    theta, intr, active=active)
        out = render_projected(
            proj, rcfg, rgbs=rgbs, bg=bg,
            tile_capacity=cfg.tile_capacity, max_dup=cfg.max_dup,
            max_dup_gen=cfg.max_dup_gen, entry_capacity=cfg.entry_capacity,
            backend=cfg.backend, bins=bins,
            with_n_touched=False, assemble=False,
        )
        loss = get_loss_tracking(
            out.rgb, out.depth, out.opacity,
            gt_rgb_t, gt_depth_t, gt_mask_t, grad_mask_t, ea, eb,
            opacity_threshold=cfg.opacity_threshold,
            rgb_npix=intr.width * intr.height,
        )
        if cfg.exposure_reg > 0.0:
            loss = loss + cfg.exposure_reg * (ea * ea + eb * eb)
        return loss

    lrs = (cfg.lr_trans, cfg.lr_rot, cfg.lr_exposure, cfg.lr_exposure)
    check_exit = cfg.convergence_threshold > 0.0
    n_segments = -(-cfg.max_iters // cfg.rebin_every)
    R, t = frame.R, frame.t
    ea, eb = frame.exposure_a, frame.exposure_b
    adam = _adam4_init(dev)
    converged = torch.zeros((), dtype=torch.bool, device=dev)
    stop = False
    i = 0
    # Outer loop: rebin once per segment; inner loop: up to rebin_every
    # iterations on the frozen bins.
    for _ in range(n_segments):
        if stop:
            break
        with torch.no_grad():
            bins = compute_bins(R, t)
        budget = min(cfg.rebin_every, cfg.max_iters - i)
        j = 0
        while j < budget and not stop:
            with fine_span("track.iter"):
                leaves = (z3.clone().requires_grad_(), z3.clone().requires_grad_(),
                          ea.detach().clone().requires_grad_(),
                          eb.detach().clone().requires_grad_())
                grads = torch.autograd.grad(loss_fn(*leaves, R, t, bins), leaves)
                with torch.no_grad():
                    upd, adam = _adam4_update(grads, adam, lrs, cfg.adam_eps)
                    d_rho, d_theta, d_ea, d_eb = upd
                    R, t = lie.apply_pose_delta(R, t, d_rho, d_theta)
                    ea = ea + d_ea
                    eb = eb + d_eb
                    tau = torch.cat([d_rho, d_theta])
                    converged = torch.sqrt(torch.sum(tau * tau)) < cfg.convergence_threshold
                j += 1
                if check_exit:
                    with host_read():    # the one device->host sync per iteration
                        stop = bool(converged)
        i += j

    # Final no-grad render for the median depth and the visibility.
    with torch.no_grad():
        out = render(
            xyz, scales, quats, opac, rgbs, R, t, intr, active=active, bg=bg,
            tile_size=cfg.tile_size, tile_capacity=cfg.tile_capacity,
            max_dup=cfg.max_dup, max_dup_gen=cfg.max_dup_gen,
            entry_capacity=cfg.entry_capacity, backend=cfg.backend,
        )
        median_depth = get_median_depth(out.depth, out.opacity > 0.0)
        n_iters = torch.tensor(i, dtype=torch.int32, device=dev)
        f32 = torch.float32
        host_stats = torch.cat([
            R.reshape(-1), t, ea[None], eb[None], n_iters.to(f32)[None],
            converged.to(f32)[None], median_depth[None],
            out.overflow.to(f32)[None], out.overflow_parts.to(f32),
        ])
    return TrackResult(
        R=R, t=t, exposure_a=ea, exposure_b=eb, n_iters=n_iters,
        converged=converged, median_depth=median_depth,
        visibility=out.n_touched > 0, render_depth=out.depth,
        render_opacity=out.opacity, overflow=out.overflow,
        overflow_parts=out.overflow_parts, host_stats=host_stats,
    )
