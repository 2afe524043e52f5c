"""Mapper: keyframe-window Gaussian optimisation and the final colour
refinement (port of monogs_tpu/slam/mapper.py).

One mapping iteration (`_mapping_iter`) renders every window keyframe with
`render_window` (one launch of each slab kernel for the whole window), sums
the per-keyframe mapping losses, takes one backward, accumulates the
densification statistics from the (du, dv) screen-space dummy, steps the
masked Adam on the Gaussians and the pose Adam on the keyframes, and
retracts the keyframe poses. `mapping_span` runs the iterations between two
cadence events as a Python loop with the JAX program's segment structure:
re-bin every `rebin_every` iterations, on frozen bins in between; given a
mesh, each rank runs its share of the window through the sharded iteration
(parallel/overlap.py), which shares the iteration's steps
(`_forward_backward`, `_densify_parts`, `_pose_step`). The
cadence events (densify, opacity resets, visibility, covisibility prune,
extend) are separate calls that rewrite the static-capacity map with masked
writes. The refinement (`refine_span`, `refine_chunk`) steps the map alone
against one keyframe at a time.

Host syncs. The JAX span is one device program. Here, with
`converged_eps <= 0` a span makes no host read at all; with
`converged_eps > 0` it reads the stall counter once per iteration (the
early exit's only sync), computing the relative improvement on the device
in float32 as the JAX loop does, so the trip counts agree.

The functions return new states and leave their inputs as they were, as
the JAX package's pure functions do; `MapperState.rng` is a
`torch.Generator` that the densify and extend events draw from.
"""

from __future__ import annotations

import dataclasses
import functools
import logging
from typing import NamedTuple

import torch

from ..models import gaussian_map as gm
from ..models.optim import AdamState, adam_step, expon_lr, init_adam
from ..ops import lie
from ..ops.binning import tile_bin
from ..ops.graphics import Intrinsics
from ..ops.losses import get_loss_mapping, l1_loss, ssim
from ..ops.projection import project_gaussians_ch
from ..ops.render import (
    bin_window,
    make_raster_config,
    project_window,
    render,
    render_window,
    tile_image,
)
from .camera import Frame, Window

log = logging.getLogger(__name__)


@dataclasses.dataclass(frozen=True)
class MapperConfig:
    """Mapping and refinement hyperparameters; the defaults are the JAX
    package's."""

    init_itr_num: int = 1050
    init_gaussian_update: int = 100
    init_gaussian_reset: int = 500
    init_gaussian_th: float = 0.005
    init_gaussian_extent: float = 30.0
    iters_per_kf: int = 300
    gaussian_update_every: int = 150
    gaussian_update_offset: int = 50
    gaussian_th: float = 0.7
    gaussian_extent: float = 1.0
    gaussian_reset: int = 2001
    size_threshold: float = 20.0
    prune_coviz: int = 3
    densify_grad_threshold: float = 2e-4
    percent_dense: float = 0.01
    spatial_lr_scale: float = 6.0
    position_lr_init: float = 1.6e-3
    position_lr_final: float = 1.6e-6
    position_lr_delay_mult: float = 0.01
    position_lr_max_steps: int = 30000
    feature_lr: float = 2.5e-3
    opacity_lr: float = 0.05
    scaling_lr: float = 1e-3
    rotation_lr: float = 1e-3
    lr_rot: float = 0.003 * 0.5
    lr_trans: float = 0.001 * 0.5
    lr_exposure: float = 0.01
    pose_adam_eps: float = 1e-8
    # Refinement. All-params refinement renders at these eval-grade caps:
    # refining geometry against renders truncated at the loop's caps
    # widens and darkens the splats around the truncated tiles, which
    # truncates more. Colours-only refinement (the default) freezes the
    # geometry, so it keeps the loop's caps and exact bins per span.
    refine_iters: int = 26000
    lambda_ssim: float = 0.2
    refine_tile_capacity: int = 4096
    refine_max_dup: int = 32
    refine_colors_only: bool = True
    tile_size: int = 32
    tile_capacity: int = 1024
    max_dup: int = 4
    max_dup_gen: int | None = 16
    entry_capacity: int | None = None
    cull_alpha: float = 1.0 / 255.0
    backend: str = "slab"          # "slab" (kernels / twins) or "ref"
    isotropic: bool = False
    monocular: bool = False
    fill_depth_dropout: bool = False
    isotropic_loss_weight: float = 0.0
    converged_eps: float = 0.0
    converged_patience: int = 4
    exposure_reg: float = 0.0
    lambda_depth: float = 0.9
    rebin_every: int = 8
    pcd_downsample_init: int = 32
    pcd_downsample: int = 64
    point_size: float = 0.01
    max_new_per_kf: int = 16384

    def map_lrs(self, step):
        """Per-leaf learning rates; xyz follows the exponential schedule
        (a () tensor when `step` is one)."""
        return {
            "xyz": expon_lr(step, self.position_lr_init * self.spatial_lr_scale,
                            self.position_lr_final * self.spatial_lr_scale,
                            0.0, self.position_lr_delay_mult,
                            self.position_lr_max_steps),
            "rgb": self.feature_lr,
            "log_scales": self.scaling_lr * self.spatial_lr_scale,
            "quats": self.rotation_lr,
            "opacity_logit": self.opacity_lr,
        }


class PoseAdam(NamedTuple):
    """Stacked Adam moments for per-keyframe (rho, theta, exp_a, exp_b)."""

    mu_rho: torch.Tensor     # (Wc, 3)
    mu_theta: torch.Tensor   # (Wc, 3)
    mu_ea: torch.Tensor      # (Wc,)
    mu_eb: torch.Tensor      # (Wc,)
    nu_rho: torch.Tensor
    nu_theta: torch.Tensor
    nu_ea: torch.Tensor
    nu_eb: torch.Tensor
    step: torch.Tensor       # () int32


def init_pose_adam(capacity: int, device="cuda") -> PoseAdam:
    z3 = torch.zeros((capacity, 3), device=device)
    z = torch.zeros(capacity, device=device)
    return PoseAdam(z3, z3, z, z, z3, z3, z, z,
                    torch.zeros((), dtype=torch.int32, device=device))


class MapperState(NamedTuple):
    gmap: gm.GaussianMap
    adam: AdamState
    window: Window
    pose_adam: PoseAdam
    nr_iters: torch.Tensor     # () int32 global (init + mapping) iteration count
    rng: torch.Generator


def init_mapper_state(capacity: int, nr_objects: int, window: Window,
                      seed: int = 0) -> MapperState:
    dev = window.valid.device
    gmap = gm.init_map(capacity, nr_objects, dev)
    return MapperState(
        gmap=gmap, adam=init_adam(gmap.params), window=window,
        pose_adam=init_pose_adam(window.capacity, dev),
        nr_iters=torch.zeros((), dtype=torch.int32, device=dev),
        rng=torch.Generator(dev).manual_seed(seed),
    )


class MappingAux(NamedTuple):
    loss: torch.Tensor
    vis_filter: torch.Tensor      # (Wc, C) bool, radii > 0 on valid slots
    overflow: torch.Tensor
    overflow_parts: torch.Tensor  # (4,) int32


# ---------------------------------------------------------------------------
# The mapping iteration.
# ---------------------------------------------------------------------------


def _render_caps(cfg: MapperConfig) -> dict:
    return dict(tile_capacity=cfg.tile_capacity, max_dup=cfg.max_dup,
                max_dup_gen=cfg.max_dup_gen, entry_capacity=cfg.entry_capacity)


@torch.no_grad()
def window_bins(state: MapperState, intr: Intrinsics, cfg: MapperConfig):
    """Tile binning of every window keyframe at the current state (TileBins
    with a leading window axis), reused across mapping iterations."""
    gmap, f = state.gmap, state.window.frames
    z = torch.zeros_like(f.t)
    p = project_window(gmap.params["xyz"], gm.get_scales(gmap.params, cfg.isotropic),
                       gmap.params["quats"], gm.get_opacity(gmap.params), f.R,
                       f.t, z, z, intr, active=gmap.active)
    opa = torch.where(p.valid, p.opacity, torch.zeros_like(p.opacity))
    return bin_window(p.u, p.v, p.radius, p.depth, p.valid, opa,
                      (p.ca, p.cb, p.cc),
                      make_raster_config(intr.width, intr.height, cfg.tile_size),
                      cull_alpha=cfg.cull_alpha, **_render_caps(cfg))


def _tile_window_gt(window: Window, intr: Intrinsics, cfg: MapperConfig):
    """The window's ground truth in the rasterizer's (T, P) tile layout,
    once per span, so the per-iteration loss runs in tile space; the mask
    is False on tile padding."""
    rcfg = make_raster_config(intr.width, intr.height, cfg.tile_size)
    f = window.frames
    pad_valid = tile_image(torch.ones(f.rgb.shape[1:3], dtype=torch.bool,
                                      device=f.rgb.device), rcfg)
    rgb_t = torch.stack([tile_image(x, rcfg) for x in f.rgb])
    depth_t = torch.stack([tile_image(x, rcfg) for x in f.depth])
    mask_t = torch.stack([tile_image(x, rcfg) for x in f.mask]) & pad_valid
    return rgb_t, depth_t, mask_t


def _pose_update(mu, nu, g, lr, bc1, bc2, eps, opt_mask):
    mu = 0.9 * mu + 0.1 * g
    nu = 0.999 * nu + 0.001 * g * g
    d = -lr * (mu / bc1) / (torch.sqrt(nu / bc2) + eps)
    m = opt_mask.reshape(opt_mask.shape + (1,) * (d.dim() - 1))
    return mu, nu, torch.where(m, d, torch.zeros_like(d))


def _forward_backward(state: MapperState, intr: Intrinsics, cfg: MapperConfig,
                      init: bool, bins, gt_tiles, n_ranks: int = 1):
    """The mapping loss over the state's window slots and its gradients.
    The global map terms (the isotropic loss) count 1 / n_ranks, so that
    their gradients summed over the ranks of a sharded window are the
    whole term's. -> (loss, the render's output, the raw gradients (params
    dict, rho, theta, exp_a, exp_b, du, dv))."""
    gmap, window = state.gmap, state.window
    Wc, C = window.capacity, gmap.capacity
    f: Frame = window.frames
    gt_rgb_t, gt_depth_t, gt_mask_t = gt_tiles
    valid_f = window.valid.to(torch.float32)
    dev = gmap.active.device

    params = {k: v.detach().requires_grad_() for k, v in gmap.params.items()}
    rhos = torch.zeros((Wc, 3), device=dev, requires_grad=True)
    thetas = torch.zeros((Wc, 3), device=dev, requires_grad=True)
    eas = f.exposure_a.detach().clone().requires_grad_()
    ebs = f.exposure_b.detach().clone().requires_grad_()
    du = torch.zeros((Wc, C), device=dev, requires_grad=True)
    dv = torch.zeros((Wc, C), device=dev, requires_grad=True)

    scales = gm.get_scales(params, cfg.isotropic)
    out = render_window(
        params["xyz"], scales, params["quats"], gm.get_opacity(params),
        params["rgb"], f.R, f.t, intr, rhos=rhos, thetas=thetas,
        active=gmap.active, tile_size=cfg.tile_size, backend=cfg.backend,
        mean2d_dummy=(du, dv), bins=bins, with_n_touched=False, assemble=False,
        **_render_caps(cfg))
    losses = torch.vmap(functools.partial(
        get_loss_mapping, init=init, lambda_depth=cfg.lambda_depth))(
        out.rgb, out.depth, gt_rgb_t, gt_depth_t, gt_mask_t, eas, ebs)
    loss = torch.sum(losses * valid_f)
    if cfg.isotropic_loss_weight > 0.0:
        dev_s = torch.abs(scales - scales.mean(1, keepdim=True))
        iso = torch.where(gmap.active[:, None], dev_s, torch.zeros_like(dev_s)).sum() / (
            3.0 * torch.clamp_min(gmap.active.sum(), 1))
        loss = loss + cfg.isotropic_loss_weight * iso / n_ranks
    if cfg.exposure_reg > 0.0:
        loss = loss + cfg.exposure_reg * torch.sum((eas * eas + ebs * ebs) * valid_f)

    keys = tuple(params)
    grads = torch.autograd.grad(
        loss, [params[k] for k in keys] + [rhos, thetas, eas, ebs, du, dv],
        allow_unused=True, materialize_grads=True)   # init leaves exposure out
    return loss.detach(), out, (dict(zip(keys, grads[:len(keys)])), *grads[len(keys):])


def _densify_parts(out, g_du, g_dv, window: Window, active: torch.Tensor,
                   intr: Intrinsics):
    """The densification statistics' terms of the window slots:
    per-keyframe screen-space gradient norms (NDC units) over the visible
    active Gaussians. -> (vis_filter, (norm sum, count, max radius) over the
    slots, each (C,))."""
    vis_filter = out.radii > 0
    norms = torch.sqrt((g_du * (intr.width * 0.5)) ** 2 + (g_dv * (intr.height * 0.5)) ** 2)
    upd = vis_filter & window.valid[:, None] & active[None, :]
    return vis_filter, (torch.where(upd, norms, torch.zeros_like(norms)).sum(0),
                        upd.sum(0).to(torch.float32),
                        torch.where(upd, out.radii, torch.zeros_like(out.radii)).amax(0))


def _mask_active(active: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """g with the rows of inactive Gaussians zeroed."""
    return torch.where(active.reshape(active.shape + (1,) * (g.dim() - 1)), g,
                       torch.zeros_like(g))


def _pose_step(state: MapperState, g_rho, g_theta, g_ea, g_eb, cfg: MapperConfig,
               init: bool):
    """The pose Adam on the window's keyframes and the retraction (frame 0
    and empty slots fixed; nothing at init). -> (window, pose Adam)."""
    window, pa = state.window, state.pose_adam
    if init:
        return window, pa
    f = window.frames
    not_frame0 = (f.frame_idx != 0) & window.valid
    step = pa.step + 1
    t_f = step.to(torch.float32)
    bc = (1.0 - 0.9 ** t_f, 1.0 - 0.999 ** t_f, cfg.pose_adam_eps, not_frame0)
    mu_r, nu_r, d_rho = _pose_update(pa.mu_rho, pa.nu_rho, g_rho, cfg.lr_trans, *bc)
    mu_t, nu_t, d_theta = _pose_update(pa.mu_theta, pa.nu_theta, g_theta, cfg.lr_rot, *bc)
    mu_a, nu_a, d_ea = _pose_update(pa.mu_ea, pa.nu_ea, g_ea, cfg.lr_exposure, *bc)
    mu_b, nu_b, d_eb = _pose_update(pa.mu_eb, pa.nu_eb, g_eb, cfg.lr_exposure, *bc)
    R_new, t_new = torch.vmap(lie.apply_pose_delta)(f.R, f.t, d_rho, d_theta)
    return (Window(frames=f._replace(R=R_new, t=t_new, exposure_a=f.exposure_a + d_ea,
                                     exposure_b=f.exposure_b + d_eb), valid=window.valid),
            PoseAdam(mu_r, mu_t, mu_a, mu_b, nu_r, nu_t, nu_a, nu_b, step))


def _mapping_iter(state: MapperState, intr: Intrinsics, cfg: MapperConfig,
                  init: bool, bins, gt_tiles):
    """One mapping iteration over the whole window (init=True: the map
    initialisation's loss, without exposure and without pose updates).
    -> (new state, MappingAux, grads) where grads are the raw gradients
    (params dict, rho, theta, exp_a, exp_b, du, dv) before masking."""
    gmap, window = state.gmap, state.window
    loss, out, grads = _forward_backward(state, intr, cfg, init, bins, gt_tiles)
    g_params, g_rho, g_theta, g_ea, g_eb, g_du, g_dv = grads
    with torch.no_grad():
        vis_filter, (acc, den, radii) = _densify_parts(out, g_du, g_dv, window,
                                                       gmap.active, intr)
        gmap = gmap._replace(xyz_grad_accum=gmap.xyz_grad_accum + acc,
                             denom=gmap.denom + den,
                             max_radii2d=torch.maximum(gmap.max_radii2d, radii))
        masked = {k: _mask_active(gmap.active, g) for k, g in g_params.items()}
        new_params, new_adam = adam_step(gmap.params, masked, state.adam,
                                         cfg.map_lrs(state.nr_iters))
        gmap = gmap._replace(params=new_params)
        new_window, pa_new = _pose_step(state, g_rho, g_theta, g_ea, g_eb, cfg, init)

    new_state = MapperState(gmap=gmap, adam=new_adam, window=new_window,
                            pose_adam=pa_new, nr_iters=state.nr_iters + 1,
                            rng=state.rng)
    aux = MappingAux(loss=loss, vis_filter=vis_filter & window.valid[:, None],
                     overflow=out.overflow, overflow_parts=out.overflow_parts)
    return new_state, aux, grads


def mapping_step(state: MapperState, intr: Intrinsics, cfg: MapperConfig,
                 init: bool = False, bins=None):
    """One mapping iteration (bins computed here unless given). -> (state,
    aux)."""
    if bins is None:
        bins = window_bins(state, intr, cfg)
    new, aux, _ = _mapping_iter(state, intr, cfg, init, bins,
                                _tile_window_gt(state.window, intr, cfg))
    return new, aux


def _zero_aux(Wc: int, C: int, device) -> MappingAux:
    return MappingAux(loss=torch.zeros((), device=device),
                      vis_filter=torch.zeros((Wc, C), dtype=torch.bool, device=device),
                      overflow=torch.zeros((), dtype=torch.int32, device=device),
                      overflow_parts=torch.zeros(4, dtype=torch.int32, device=device))


def mapping_span(state: MapperState, intr: Intrinsics, cfg: MapperConfig,
                 init: bool, n_segments: int, tail_len: int, mesh=None):
    """n_segments * rebin_every + tail_len mapping iterations, re-binning at
    the start of every segment (the tail segment always re-bins once;
    callers keep tail_len in [1, rebin_every]).

    Convergence early exit (cfg.converged_eps > 0; the reference runs fixed
    counts): stop once the window loss's relative improvement stays below
    converged_eps for converged_patience consecutive iterations; the stall
    counter carries across segments. -> (state, aux of the last iteration
    run, or zeros when none ran).

    With a `mesh` (parallel/mesh.py) the span runs on this rank's share of
    the window and the Adam rows (`parallel/overlap.sharded_mapping_iter`),
    and the whole state is gathered back at its end."""
    whole = state
    step = _mapping_iter
    if mesh is not None:
        from ..parallel import mesh as pmesh
        from ..parallel.overlap import sharded_mapping_iter

        state = pmesh.shard_mapper_state(state, mesh)
        step = functools.partial(sharded_mapping_iter, mesh=mesh,
                                 rows=pmesh.zero_rows(mesh, state.gmap.capacity))
    gt_tiles = _tile_window_gt(state.window, intr, cfg)
    dev = state.gmap.active.device
    aux = _zero_aux(state.window.capacity, state.gmap.capacity, dev)
    eps = float(cfg.converged_eps)
    prev = torch.full((), float("inf"), device=dev)
    stall = torch.zeros((), dtype=torch.int32, device=dev)
    stalled = False
    for m in [cfg.rebin_every] * n_segments + [tail_len]:
        if stalled:
            break
        bins = window_bins(state, intr, cfg)
        for _ in range(m):
            state, aux, _ = step(state, intr, cfg, init, bins, gt_tiles)
            if eps > 0.0:
                rel = (prev - aux.loss) / torch.clamp_min(prev.abs(), 1e-12)
                stall = torch.where(rel < eps, stall + 1, torch.zeros_like(stall))
                prev = aux.loss
                # The early exit's one host read per iteration.
                stalled = int(stall) >= cfg.converged_patience
                if stalled:
                    break
    if mesh is not None:
        state, aux = pmesh.unshard_mapper_state(state, aux, mesh, like=whole)
    return state, aux


def window_host_pack(state: MapperState) -> torch.Tensor:
    """What the host bookkeeping reads after a keyframe event, in ONE
    buffer: [R.ravel (Wc*9), t.ravel (Wc*3), exposure_a (Wc), exposure_b
    (Wc)]."""
    f = state.window.frames
    return torch.cat([f.R.reshape(-1), f.t.reshape(-1), f.exposure_a, f.exposure_b])


def unpack_window_host(pack: torch.Tensor, Wc: int) -> dict:
    """Decode window_host_pack with one host read -> numpy arrays R (Wc, 3,
    3), t (Wc, 3), exposure_a (Wc,), exposure_b (Wc,)."""
    s = pack.detach().cpu().numpy()
    return {
        "R": s[: Wc * 9].reshape(Wc, 3, 3),
        "t": s[Wc * 9: Wc * 12].reshape(Wc, 3),
        "exposure_a": s[Wc * 12: Wc * 13],
        "exposure_b": s[Wc * 13: Wc * 14],
    }


# ---------------------------------------------------------------------------
# Cadence events.
# ---------------------------------------------------------------------------


def densify_event(state: MapperState, cfg: MapperConfig, init_phase: bool,
                  split_noise: torch.Tensor | None = None):
    """Densify and prune at the cadence (init phase: the init thresholds and
    no screen-size prune). -> (state, (n_cloned, n_split, n_pruned,
    n_dropped))."""
    if init_phase:
        th, extent, max_screen = cfg.init_gaussian_th, cfg.init_gaussian_extent, None
    else:
        th, extent, max_screen = cfg.gaussian_th, cfg.gaussian_extent, cfg.size_threshold
    gmap, adam, *counts = gm.densify_and_prune(
        state.gmap, state.adam, state.rng, max_grad=cfg.densify_grad_threshold,
        min_opacity=th, extent=extent, max_screen_size=max_screen,
        percent_dense=cfg.percent_dense, isotropic=cfg.isotropic,
        split_noise=split_noise)
    return state._replace(gmap=gmap, adam=adam), tuple(counts)


def reset_opacity_event(state: MapperState) -> MapperState:
    gmap, adam = gm.reset_opacity(state.gmap, state.adam)
    return state._replace(gmap=gmap, adam=adam)


def reset_nonvisible_event(state: MapperState, visible: torch.Tensor) -> MapperState:
    gmap, adam = gm.reset_opacity_nonvisible(state.gmap, state.adam, visible)
    return state._replace(gmap=gmap, adam=adam)


@torch.no_grad()
def visibility_pass(state: MapperState, intr: Intrinsics,
                    cfg: MapperConfig) -> torch.Tensor:
    """No-grad window render for visibility only: (Wc, C) bool n_touched > 0
    on valid slots."""
    gmap, f = state.gmap, state.window.frames
    z = torch.zeros_like(f.t)
    out = render_window(
        gmap.params["xyz"], gm.get_scales(gmap.params, cfg.isotropic),
        gmap.params["quats"], gm.get_opacity(gmap.params), gmap.params["rgb"],
        f.R, f.t, intr, rhos=z, thetas=z, active=gmap.active,
        tile_size=cfg.tile_size, backend=cfg.backend, **_render_caps(cfg))
    return (out.n_touched > 0) & state.window.valid[:, None]


def covisibility_prune(state: MapperState, visibility: torch.Tensor,
                       kf_idx_floor, cfg: MapperConfig):
    """Prune Gaussians created at keyframes >= kf_idx_floor that were seen
    by at most prune_coviz window keyframes. -> (state, prune mask)."""
    gmap = state.gmap
    nr_obs = visibility.to(torch.int32).sum(0, dtype=torch.int32)
    gmap = gmap._replace(nr_obs=nr_obs)
    to_prune = (nr_obs <= cfg.prune_coviz) & (gmap.kf_idx >= kf_idx_floor) & gmap.active
    gmap, adam = gm.prune_points(gmap, state.adam, to_prune)
    return state._replace(gmap=gmap, adam=adam), to_prune


@torch.no_grad()
def extend_event(state: MapperState, frame: Frame, kf_idx, intr: Intrinsics,
                 cfg: MapperConfig, init: bool, scores_u=None, depth_noise=None):
    """Render the map from the new keyframe (no grad) for the densification
    mask, then seed Gaussians from it into free slots. -> (state, (n_added,
    n_dropped))."""
    gmap = state.gmap
    render_depth = render_opacity = None
    if not init:
        out = render(gmap.params["xyz"], gm.get_scales(gmap.params, cfg.isotropic),
                     gmap.params["quats"], gm.get_opacity(gmap.params),
                     gmap.params["rgb"], frame.R, frame.t, intr, active=gmap.active,
                     backend=cfg.backend, **_render_caps(cfg))
        render_depth, render_opacity = out.depth, out.opacity
    res = gm.extend_from_keyframe(
        gmap, state.adam, state.rng, rgb=frame.rgb, depth=frame.depth,
        segmentation=frame.segmentation, R_w2c=frame.R, t_w2c=frame.t, intr=intr,
        kf_idx=kf_idx, exposure_a=frame.exposure_a, exposure_b=frame.exposure_b,
        render_depth=render_depth, render_opacity=render_opacity, init=init,
        isotropic=cfg.isotropic, monocular=cfg.monocular,
        fill_depth_dropout=cfg.fill_depth_dropout,
        downsample_init=cfg.pcd_downsample_init, downsample=cfg.pcd_downsample,
        point_size=cfg.point_size, max_new=cfg.max_new_per_kf,
        scores_u=scores_u, depth_noise=depth_noise)
    return state._replace(gmap=res.map, adam=res.adam), (res.n_added, res.n_dropped)


# ---------------------------------------------------------------------------
# Refinement: colour refinement of the final map over its keyframes.
# ---------------------------------------------------------------------------

REFINE_LEAVES = ("rgb", "opacity_logit")   # what colours-only refinement moves


def _refine_iter(state: MapperState, frame: Frame, intr: Intrinsics,
                 cfg: MapperConfig, bins=None):
    """One refinement iteration on one keyframe: (1 - lambda_ssim) L1 +
    lambda_ssim (1 - SSIM) of the exposure-corrected render against the
    keyframe's rgb, then the masked Adam on the Gaussians (the learning
    rates continue the mapping schedule at nr_iters).

    Colours-only (the default): only rgb and opacity_logit take gradients;
    the other leaves get zero gradients and lr 0, so warm moments from the
    mapping loop cannot move the geometry, while Adam still steps (and
    decays) every leaf's moments as the JAX package's does. It renders at
    the loop's caps; all-params mode at the eval-grade caps.
    -> (state, overflow as a () device tensor)."""
    gmap = state.gmap
    if cfg.refine_colors_only:
        opt, caps = REFINE_LEAVES, _render_caps(cfg)
    else:
        opt = tuple(gmap.params)
        caps = dict(tile_capacity=max(cfg.tile_capacity, cfg.refine_tile_capacity),
                    max_dup=max(cfg.max_dup, cfg.refine_max_dup), max_dup_gen=None,
                    entry_capacity=None)
    params = {k: v.detach().requires_grad_() if k in opt else v
              for k, v in gmap.params.items()}
    out = render(params["xyz"], gm.get_scales(params, cfg.isotropic), params["quats"],
                 gm.get_opacity(params), params["rgb"], frame.R, frame.t, intr,
                 active=gmap.active, tile_size=cfg.tile_size, backend=cfg.backend,
                 bins=bins, with_n_touched=False, **caps)
    rgb = torch.exp(frame.exposure_a) * out.rgb + frame.exposure_b
    loss = ((1.0 - cfg.lambda_ssim) * l1_loss(rgb, frame.rgb)
            + cfg.lambda_ssim * (1.0 - ssim(rgb, frame.rgb)))
    g_opt = torch.autograd.grad(loss, [params[k] for k in opt])

    with torch.no_grad():
        grads = dict(zip(opt, g_opt))
        act, C = gmap.active, gmap.capacity
        grads = {k: torch.where(act.reshape((C,) + (1,) * (v.dim() - 1)), grads[k],
                                torch.zeros_like(v)) if k in grads else torch.zeros_like(v)
                 for k, v in gmap.params.items()}
        lrs = cfg.map_lrs(state.nr_iters)
        if cfg.refine_colors_only:
            lrs = {k: v if k in opt else 0.0 for k, v in lrs.items()}
        new_params, new_adam = adam_step(gmap.params, grads, state.adam, lrs)
    return state._replace(gmap=gmap._replace(params=new_params), adam=new_adam,
                          nr_iters=state.nr_iters + 1), out.overflow


# Eager PyTorch has no jit: the single-iteration entry point is the
# iteration itself.
refine_step = _refine_iter


def refine_chunk(state: MapperState, frames: Frame, intr: Intrinsics,
                 cfg: MapperConfig):
    """One refinement iteration on each of B stacked frames (a Frame with a
    leading batch axis), in order. -> (state, max overflow on the
    device)."""
    ov_max = torch.zeros((), dtype=torch.int32, device=state.gmap.active.device)
    for i in range(frames.frame_idx.shape[0]):
        state, ov = _refine_iter(state, Frame(*(x[i] for x in frames)), intr, cfg)
        ov_max = torch.maximum(ov_max, ov)
    return state, ov_max


def refine_span(state: MapperState, frame: Frame, intr: Intrinsics,
                cfg: MapperConfig, n_iters: int):
    """n_iters colours-only refinement iterations on one keyframe, tile-
    binned once at the span's starting state (colours-only refinement
    freezes the geometry, so only the opacity cull drifts within a span);
    each iteration re-projects, since the opacities move, and reuses the
    bins. -> (state, max overflow over the span on the device)."""
    gmap = state.gmap
    with torch.no_grad():
        z3 = torch.zeros(3, device=gmap.active.device)
        proj = project_gaussians_ch(
            gmap.params["xyz"], gm.get_scales(gmap.params, cfg.isotropic),
            gmap.params["quats"], gm.get_opacity(gmap.params), frame.R, frame.t, z3, z3,
            intr, active=gmap.active)
        bins = tile_bin(
            None, proj.radius, proj.depth, proj.valid, img_w=intr.width,
            img_h=intr.height, tile_size=cfg.tile_size, tile_capacity=cfg.tile_capacity,
            max_dup=cfg.max_dup, entry_capacity=cfg.entry_capacity,
            opacity=torch.where(proj.valid, proj.opacity, torch.zeros_like(proj.opacity)),
            conic=(proj.ca, proj.cb, proj.cc), uv=(proj.u, proj.v),
            max_dup_gen=cfg.max_dup_gen)
    ov_max = torch.zeros((), dtype=torch.int32, device=gmap.active.device)
    for _ in range(n_iters):
        state, ov = _refine_iter(state, frame, intr, cfg, bins=bins)
        ov_max = torch.maximum(ov_max, ov)
    return state, ov_max


# ---------------------------------------------------------------------------
# Host drivers: cadence logic over device spans.
# ---------------------------------------------------------------------------


def _next_event(cur: int, moduli_offsets) -> int:
    """Smallest it > cur with it % m == o for some (m, o)."""
    best = 1 << 30
    for m, o in moduli_offsets:
        if m <= 0:
            continue
        best = min(best, cur + 1 + (o - (cur + 1)) % m)
    return best


def _span_args(n: int, rebin_every: int) -> tuple[int, int]:
    """n >= 1 iterations -> (n_segments, tail) with tail in [1, rebin_every]."""
    n_seg = (n - 1) // rebin_every
    return n_seg, n - n_seg * rebin_every


def _log_overflow(parts) -> None:
    overflow, g, d, t, s = (int(x) for x in parts)
    if overflow > 1000:
        log.warning("binning overflow %d entries/iter (gen-width %d / dup-cap %d / "
                    "tile-cap %d / slab-cap %d): raise max_dup_gen / max_dup / "
                    "tile_capacity / entry_capacity respectively",
                    overflow, g, d, t, s)


def run_initialize_map(state: MapperState, intr: Intrinsics, cfg: MapperConfig,
                       mesh=None):
    """The map initialisation: init_itr_num iterations on the init keyframe
    with densify every init_gaussian_update and an opacity reset at
    init_gaussian_reset (sharded over `mesh`'s ranks when given).
    -> (state, visibility (Wc, C))."""
    cur = int(state.nr_iters)
    end = cur + cfg.init_itr_num
    while cur < end:
        stop = min(_next_event(cur, [(cfg.init_gaussian_update, 1)]),
                   cfg.init_gaussian_reset if cfg.init_gaussian_reset > cur else 1 << 30,
                   end)
        state, _ = mapping_span(state, intr, cfg, True,
                                *_span_args(stop - cur, cfg.rebin_every), mesh=mesh)
        cur = stop
        if cfg.converged_eps > 0.0:
            # An early exit ran fewer iterations than the schedule: pin the
            # counter to the schedule (cadence and xyz lr stay aligned).
            state = state._replace(nr_iters=torch.full_like(state.nr_iters, cur))
        if (cur - 1) % cfg.init_gaussian_update == 0:
            state, _ = densify_event(state, cfg, init_phase=True)
        if cur == cfg.init_gaussian_reset:
            state = reset_opacity_event(state)
    return state, visibility_pass(state, intr, cfg)


def run_optimize_map(state: MapperState, intr: Intrinsics, cfg: MapperConfig,
                     iters: int, defer_overflow_read: bool = True, mesh=None):
    """The per-keyframe mapping loop: `iters` iterations in spans between
    the cadence events (densify at gaussian_update_every / offset, the
    non-visible opacity reset at gaussian_reset), sharded over `mesh`'s
    ranks when given. -> (state, visibility).

    Overflow telemetry, read to log each span over the limit: deferred
    (the synchronous mode, where the mapper owns the device), every span's
    (overflow, parts) stays on the device and ONE read at the end logs
    them; not deferred (the concurrent mode), one read per span, so the
    mapper's thread never runs more than a span ahead of the device and
    the tracker's work is not queued behind a whole event."""
    cur = int(state.nr_iters)
    end = cur + iters
    span_ovs = []
    while cur < end:
        stop = min(_next_event(cur, [(cfg.gaussian_update_every, cfg.gaussian_update_offset),
                                     (cfg.gaussian_reset, 0)]), end)
        state, aux = mapping_span(state, intr, cfg, False,
                                  *_span_args(stop - cur, cfg.rebin_every), mesh=mesh)
        cur = it = stop
        if cfg.converged_eps > 0.0:
            state = state._replace(nr_iters=torch.full_like(state.nr_iters, cur))
        parts = torch.cat([aux.overflow[None], aux.overflow_parts])
        if defer_overflow_read:
            span_ovs.append(parts)
        else:
            _log_overflow(parts.cpu())                 # one read for the span
        if it % cfg.gaussian_update_every == cfg.gaussian_update_offset:
            state, _ = densify_event(state, cfg, init_phase=False)
        elif it % cfg.gaussian_reset == 0:
            state = reset_nonvisible_event(state, aux.vis_filter.any(0))
    vis = visibility_pass(state, intr, cfg)
    if span_ovs:
        for parts in torch.stack(span_ovs).cpu():     # one read for the event
            _log_overflow(parts)
    return state, vis
