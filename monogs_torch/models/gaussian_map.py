"""GaussianMap: the SLAM map as a static-capacity struct of arrays (port of
monogs_tpu/models/gaussian_map.py).

Parameters are dictionary leaves of a fixed capacity C with an `active`
row mask, so every topology operation (extend, clone, split, prune) is a
masked write with no optimiser-state surgery: the Adam moments are masked
the same way (models/optim.py). Capacity growth (`grow`) is the only change
of shape. `params` is a dict of tensors under the JAX package's keys:
xyz, rgb, log_scales, quats (unnormalised wxyz), opacity_logit.

Conventions as in the JAX package: rgb stores plain colours, opacity is a
logit, scales are logs, isotropic mode ties the three log-scales to channel
0, obj_prob holds per-Gaussian object one-hots, kf_idx / nr_obs serve the
covisibility prune.

Randomness. The JAX functions draw from a key; these take a
`torch.Generator` and, where a test feeds the JAX package's own draws, the
draws themselves (`scores_u`, `depth_noise`, `split_noise`). Every function
returns new tensors and leaves its inputs as they were. No function reads a
device value on the host.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops import lie
from ..ops.graphics import Intrinsics, cam_to_world, unproject
from ..ops.knn import knn_mean_sq_dist
from ..ops.losses import _midpoint_median     # jnp.nanmedian's semantics
from .optim import AdamState, mask_rows, zero_leaf

PARAM_KEYS = ("xyz", "rgb", "log_scales", "quats", "opacity_logit")


class GaussianMap(NamedTuple):
    params: dict                 # learned leaves under PARAM_KEYS
    obj_prob: torch.Tensor       # (C, n_objects)
    kf_idx: torch.Tensor         # (C,) int32 creating keyframe
    nr_obs: torch.Tensor         # (C,) int32 observation count
    active: torch.Tensor         # (C,) bool
    max_radii2d: torch.Tensor    # (C,) densification statistics
    xyz_grad_accum: torch.Tensor  # (C,)
    denom: torch.Tensor          # (C,)

    @property
    def capacity(self) -> int:
        return self.active.shape[0]

    @property
    def num_active(self) -> torch.Tensor:
        return self.active.sum(dtype=torch.int32)


def inverse_sigmoid(x: float) -> float:
    """log(x / (1 - x)): the ratio in double, its log in float32, as the
    JAX package computes it."""
    return float(torch.log(torch.tensor(x / (1.0 - x), dtype=torch.float32)))


def init_map(capacity: int, nr_objects: int = 1, device="cuda") -> GaussianMap:
    C, f32 = capacity, torch.float32
    params = {
        "xyz": torch.zeros((C, 3), dtype=f32, device=device),
        "rgb": torch.zeros((C, 3), dtype=f32, device=device),
        "log_scales": torch.full((C, 3), -10.0, dtype=f32, device=device),
        "quats": torch.tensor([1.0, 0, 0, 0], device=device).repeat(C, 1),
        "opacity_logit": torch.full((C,), -10.0, dtype=f32, device=device),
    }
    return GaussianMap(
        params=params,
        obj_prob=torch.zeros((C, nr_objects), dtype=f32, device=device),
        kf_idx=torch.zeros(C, dtype=torch.int32, device=device),
        nr_obs=torch.zeros(C, dtype=torch.int32, device=device),
        active=torch.zeros(C, dtype=torch.bool, device=device),
        max_radii2d=torch.zeros(C, dtype=f32, device=device),
        xyz_grad_accum=torch.zeros(C, dtype=f32, device=device),
        denom=torch.zeros(C, dtype=f32, device=device),
    )


def get_scales(params: dict, isotropic: bool) -> torch.Tensor:
    """Activated (C, 3) scales; isotropic ties all axes to channel 0."""
    ls = params["log_scales"]
    if isotropic:
        ls = ls[:, 0:1].expand(ls.shape)
    return torch.exp(ls)


def get_opacity(params: dict) -> torch.Tensor:
    return torch.sigmoid(params["opacity_logit"])


# ---------------------------------------------------------------------------
# Slot allocation (static-shape replacement for concatenation).
# ---------------------------------------------------------------------------


def _alloc_slots(active: torch.Tensor, want: torch.Tensor):
    """A distinct free slot for each row i with want[i], in row order.

    -> (dest (C,) int64: the slot, or C where none was given; ok (C,) bool:
    the want rows that got a slot; dropped () int32: those that did not)."""
    C = active.shape[0]
    free_pos = torch.sort(active.to(torch.int32), stable=True).indices
    n_free = C - active.sum()
    want_rank = torch.cumsum(want.to(torch.int64), 0) - 1
    ok = want & (want_rank < n_free)
    dest = torch.where(ok, free_pos[torch.clamp(want_rank, 0, C - 1)],
                       torch.full_like(want_rank, C))
    dropped = (want.sum() - ok.sum()).to(torch.int32)
    return dest, ok, dropped


def _scatter_rows(arr: torch.Tensor, dest: torch.Tensor,
                  values: torch.Tensor) -> torch.Tensor:
    """arr with arr[dest[i]] = values[i] wherever dest[i] < C (rows with
    dest == C go to a spare row that is cut off)."""
    ext = torch.cat([arr, arr[:1]])
    ext.index_copy_(0, dest, values.to(arr.dtype).expand((dest.shape[0],) + arr.shape[1:]))
    return ext[:-1]


# ---------------------------------------------------------------------------
# Extend from a keyframe.
# ---------------------------------------------------------------------------


class ExtendResult(NamedTuple):
    map: GaussianMap
    adam: AdamState
    n_added: torch.Tensor    # () int32
    n_dropped: torch.Tensor  # () int32 candidates without capacity


def extend_from_keyframe(
    gmap: GaussianMap,
    adam: AdamState,
    generator: torch.Generator | None = None,
    *,
    rgb: torch.Tensor,            # (H, W, 3)
    depth: torch.Tensor,          # (H, W), 0 invalid
    segmentation: torch.Tensor,   # (H, W) int32
    R_w2c: torch.Tensor,
    t_w2c: torch.Tensor,
    intr: Intrinsics,
    kf_idx,
    exposure_a: torch.Tensor,
    exposure_b: torch.Tensor,
    render_depth: torch.Tensor | None = None,
    render_opacity: torch.Tensor | None = None,
    init: bool = False,
    downsample_init: int = 32,
    downsample: int = 64,
    point_size: float = 0.01,
    max_new: int = 16384,
    isotropic: bool = False,
    monocular: bool = False,
    mono_init_depth: float = 2.0,
    mono_depth_noise: float = 0.3,
    fill_depth_dropout: bool = False,
    scores_u: torch.Tensor | None = None,     # (H*W,) U[0, 1) draws
    depth_noise: torch.Tensor | None = None,  # (H, W) N(0, 1) draws
) -> ExtendResult:
    """Seed new Gaussians from a keyframe.

    Densification mask: valid depth AND (rendered opacity < 0.5 OR (gt depth
    < rendered depth AND |err| > 50 median err)). floor(n_masked /
    downsample) of the masked pixels, capped by max_new and the free
    capacity, are drawn by a weighted random top-k (score U + valid) and
    unprojected; scales start from the 3-NN mean distance times point_size.
    Monocular mode synthesises the seed depth as a noisy constant (init) or
    a noisy rendered-depth median. The top-k is a stable descending sort,
    so ties go to the lower pixel index as in jax.lax.top_k."""
    H, W = depth.shape
    dev = depth.device
    if scores_u is None:
        scores_u = torch.rand(H * W, generator=generator, device=dev)
    if depth_noise is None and (monocular or fill_depth_dropout):
        depth_noise = torch.randn((H, W), generator=generator, device=dev)
    if init:
        img, factor = rgb, downsample_init
    else:
        img = torch.clamp(torch.exp(exposure_a) * rgb + exposure_b, 0.0, 1.0)
        factor = downsample
    nan = torch.full_like(depth, float("nan"))

    if monocular:
        if init or render_depth is None:
            base = torch.tensor(mono_init_depth, dtype=depth.dtype, device=dev)
        else:
            med = _midpoint_median(torch.where(render_depth > 1e-3, render_depth, nan))
            base = torch.nan_to_num(med, nan=mono_init_depth)
        depth = base * (1.0 + mono_depth_noise * depth_noise)
        depth = torch.maximum(depth, 0.1 * base)
        valid = torch.ones((H, W), dtype=torch.bool, device=dev)
        if not init and render_opacity is not None:
            valid = render_opacity < 0.5
    else:
        valid_sensor = depth >= 1e-3
        valid = valid_sensor
        if not init and render_depth is not None:
            opa_mask = render_opacity < 0.5
            err = torch.abs(depth - render_depth)
            median_err = torch.nan_to_num(_midpoint_median(torch.where(valid, err, nan)),
                                          nan=0.0)
            cond = (depth < render_depth) & (err > 50.0 * median_err)
            valid = valid & (opa_mask | cond)
        if fill_depth_dropout:
            med = torch.nan_to_num(_midpoint_median(torch.where(valid_sensor, depth, nan)),
                                   nan=mono_init_depth)
            synth = torch.maximum(med * (1.0 + mono_depth_noise * depth_noise),
                                  0.1 * med)
            depth = torch.where(valid_sensor, depth, synth)
            hole_ok = ~valid_sensor
            if not init and render_opacity is not None:
                hole_ok = hole_ok & (render_opacity < 0.5)
            valid = valid | hole_ok

    max_new = min(max_new, H * W)
    flat_valid = valid.reshape(-1)
    n_valid = flat_valid.sum(dtype=torch.int32)
    n_keep = torch.clamp_max(torch.div(n_valid, factor, rounding_mode="floor"),
                             max_new)
    scores = scores_u + flat_valid.to(torch.float32)
    pick = torch.sort(scores, descending=True, stable=True).indices[:max_new]
    keep = torch.arange(max_new, device=dev) < n_keep

    pts_cam = unproject(depth, intr).reshape(-1, 3)[pick]
    pts_world = cam_to_world(R_w2c, t_w2c, pts_cam)
    cols = img.reshape(-1, 3)[pick]
    seg = segmentation.reshape(-1)[pick]

    p_size = torch.clamp_max(
        point_size * _midpoint_median(torch.where(valid, depth, nan)), 0.05)
    dist2 = torch.clamp_min(knn_mean_sq_dist(pts_world, mask=keep), 1e-7) * p_size
    log_scale = 0.5 * torch.log(dist2)

    dest, ok, dropped = _alloc_slots(gmap.active, keep)
    p = gmap.params
    quat0 = torch.tensor([1.0, 0, 0, 0], device=dev).expand(max_new, 4)
    params = {
        "xyz": _scatter_rows(p["xyz"], dest, pts_world),
        "rgb": _scatter_rows(p["rgb"], dest, cols),
        "log_scales": _scatter_rows(p["log_scales"], dest,
                                    log_scale[:, None].expand(max_new, 3)),
        "quats": _scatter_rows(p["quats"], dest, quat0),
        "opacity_logit": _scatter_rows(
            p["opacity_logit"], dest,
            torch.full((max_new,), inverse_sigmoid(0.5), device=dev)),
    }
    nr_objects = gmap.obj_prob.shape[1]
    onehot = torch.nn.functional.one_hot(
        torch.clamp(seg.to(torch.int64), 0, nr_objects - 1), nr_objects)
    new_active = _scatter_rows(gmap.active, dest, ok)
    new_map = GaussianMap(
        params=params,
        obj_prob=_scatter_rows(gmap.obj_prob, dest, onehot),
        kf_idx=_scatter_rows(gmap.kf_idx, dest, torch.as_tensor(
            kf_idx, dtype=torch.int32, device=dev).expand(max_new)),
        nr_obs=_scatter_rows(gmap.nr_obs, dest, torch.zeros(
            max_new, dtype=torch.int32, device=dev)),
        active=new_active,
        # The densification statistics restart for ALL rows.
        max_radii2d=torch.zeros_like(gmap.max_radii2d),
        xyz_grad_accum=torch.zeros_like(gmap.xyz_grad_accum),
        denom=torch.zeros_like(gmap.denom),
    )
    return ExtendResult(map=new_map, adam=mask_rows(adam, new_active != gmap.active),
                        n_added=ok.sum(dtype=torch.int32), n_dropped=dropped)


# ---------------------------------------------------------------------------
# Densify / prune.
# ---------------------------------------------------------------------------


def prune_points(gmap: GaussianMap, adam: AdamState, prune_mask: torch.Tensor):
    """Deactivate rows; their moments are zeroed and their opacity parked
    at logit -10, so a reallocated slot starts clean."""
    prune_mask = prune_mask & gmap.active
    params = dict(gmap.params)
    params["opacity_logit"] = torch.where(
        prune_mask, torch.full_like(params["opacity_logit"], -10.0),
        params["opacity_logit"])
    gmap = gmap._replace(params=params, active=gmap.active & ~prune_mask)
    return gmap, mask_rows(adam, prune_mask)


def densify_and_prune(
    gmap: GaussianMap,
    adam: AdamState,
    generator: torch.Generator | None = None,
    *,
    max_grad: float,
    min_opacity: float,
    extent: float,
    max_screen_size: float | None,
    percent_dense: float = 0.01,
    isotropic: bool = False,
    split_noise: torch.Tensor | None = None,   # (2, C, 3) N(0, 1) draws
):
    """Clone, split and prune. -> (map, adam, n_cloned, n_split, n_pruned,
    n_dropped), the counts () int32 tensors.

    Clone: small Gaussians with a large mean screen gradient are copied
    into free slots. Split: large ones are replaced by two samples at
    scale / 1.6, the first in place (only when the second found a slot),
    the second in a free slot. Prune: opacity below min_opacity, or (with
    max_screen_size) screen radius or world scale too large. Rows rewritten
    by clone or split restart their max screen radius; others keep it for
    the size prune (the JAX package's deliberate order)."""
    C = gmap.capacity
    dev = gmap.active.device
    grads = torch.where(gmap.denom > 0,
                        gmap.xyz_grad_accum / torch.clamp_min(gmap.denom, 1.0),
                        torch.zeros_like(gmap.denom))
    scales = get_scales(gmap.params, isotropic)
    max_scale = scales.amax(1)

    clone_mask = gmap.active & (grads >= max_grad) & (max_scale <= percent_dense * extent)
    dest, ok_c, drop_c = _alloc_slots(gmap.active, clone_mask)
    params = {k: _scatter_rows(v, dest, v) for k, v in gmap.params.items()}
    active = _scatter_rows(gmap.active, dest, ok_c)
    obj_prob = _scatter_rows(gmap.obj_prob, dest, gmap.obj_prob)
    kf_idx = _scatter_rows(gmap.kf_idx, dest, gmap.kf_idx)
    nr_obs = _scatter_rows(gmap.nr_obs, dest, gmap.nr_obs)
    new_rows = active != gmap.active
    adam = mask_rows(adam, new_rows)

    split_mask = gmap.active & (grads >= max_grad) & (max_scale > percent_dense * extent)
    R = lie.quat_to_rotmat(params["quats"])
    if split_noise is None:
        split_noise = torch.randn((2, C, 3), generator=generator, device=dev)
    eps1, eps2 = split_noise[0], split_noise[1]
    s1 = params["xyz"] + (R * (eps1 * scales)[:, None, :]).sum(-1)
    s2 = params["xyz"] + (R * (eps2 * scales)[:, None, :]).sum(-1)
    new_log_scales = params["log_scales"] - float(torch.log(torch.tensor(1.6)))

    dest2, ok_s, drop_s = _alloc_slots(active, split_mask)
    repl = split_mask & ok_s
    params["xyz"] = torch.where(repl[:, None], s1, params["xyz"])
    params["log_scales"] = torch.where(repl[:, None], new_log_scales,
                                       params["log_scales"])
    sibling = {"xyz": s2, "log_scales": new_log_scales}
    params = {k: _scatter_rows(v, dest2, sibling.get(k, v)) for k, v in params.items()}
    active2 = _scatter_rows(active, dest2, ok_s)
    obj_prob = _scatter_rows(obj_prob, dest2, obj_prob)
    kf_idx = _scatter_rows(kf_idx, dest2, kf_idx)
    nr_obs = _scatter_rows(nr_obs, dest2, nr_obs)
    changed = repl | (active2 != active)
    adam = mask_rows(adam, changed)
    active = active2

    radii_carried = torch.where(new_rows | changed,
                                torch.zeros_like(gmap.max_radii2d), gmap.max_radii2d)
    gmap = GaussianMap(
        params=params, obj_prob=obj_prob, kf_idx=kf_idx, nr_obs=nr_obs,
        active=active, max_radii2d=radii_carried,
        xyz_grad_accum=torch.zeros_like(gmap.xyz_grad_accum),
        denom=torch.zeros_like(gmap.denom),
    )

    prune_mask = get_opacity(gmap.params) < min_opacity
    if max_screen_size is not None:
        big_vs = gmap.max_radii2d > max_screen_size
        big_ws = get_scales(gmap.params, isotropic).amax(1) > 0.1 * extent
        prune_mask = prune_mask | big_vs | big_ws
    n_pruned = (prune_mask & gmap.active).sum(dtype=torch.int32)
    gmap, adam = prune_points(gmap, adam, prune_mask)
    gmap = gmap._replace(max_radii2d=torch.zeros_like(gmap.max_radii2d))
    return (gmap, adam, ok_c.sum(dtype=torch.int32), ok_s.sum(dtype=torch.int32),
            n_pruned, drop_c + drop_s)


def add_densification_stats(gmap: GaussianMap, mean2d_grad_px: torch.Tensor,
                            update_filter: torch.Tensor, img_w: int,
                            img_h: int) -> GaussianMap:
    """Accumulate screen-space gradient norms, converted from pixel units
    to the CUDA rasterizer's NDC units (x W/2, y H/2)."""
    g = mean2d_grad_px * torch.tensor([[img_w * 0.5, img_h * 0.5]],
                                      device=mean2d_grad_px.device)
    norm = torch.linalg.vector_norm(g, dim=-1)
    upd = update_filter & gmap.active
    return gmap._replace(
        xyz_grad_accum=gmap.xyz_grad_accum + torch.where(upd, norm, torch.zeros_like(norm)),
        denom=gmap.denom + upd.to(torch.float32))


def update_max_radii(gmap: GaussianMap, radii: torch.Tensor,
                     visibility: torch.Tensor) -> GaussianMap:
    return gmap._replace(max_radii2d=torch.where(
        visibility & gmap.active, torch.maximum(gmap.max_radii2d, radii),
        gmap.max_radii2d))


def reset_opacity(gmap: GaussianMap, adam: AdamState):
    """All opacities -> 0.01; the opacity moments are zeroed."""
    params = dict(gmap.params)
    params["opacity_logit"] = torch.full_like(params["opacity_logit"],
                                              inverse_sigmoid(0.01))
    return gmap._replace(params=params), zero_leaf(adam, "opacity_logit")


def reset_opacity_nonvisible(gmap: GaussianMap, adam: AdamState,
                             visible: torch.Tensor):
    """Opacities of active, non-visible rows -> 0.4."""
    params = dict(gmap.params)
    params["opacity_logit"] = torch.where(
        visible | ~gmap.active, params["opacity_logit"],
        torch.full_like(params["opacity_logit"], inverse_sigmoid(0.4)))
    return gmap._replace(params=params), zero_leaf(adam, "opacity_logit")


def increment_nr_obs(gmap: GaussianMap, observed: torch.Tensor) -> GaussianMap:
    return gmap._replace(nr_obs=gmap.nr_obs + (observed & gmap.active).to(torch.int32))


def grow(gmap: GaussianMap, adam: AdamState, new_capacity: int):
    """Pad every row array to a larger capacity; new rows are init_map's."""
    C = gmap.capacity
    if new_capacity < C:
        raise ValueError(f"cannot grow capacity {C} to {new_capacity}")
    fresh = init_map(new_capacity, gmap.obj_prob.shape[1], gmap.active.device)

    def merge(old, template):
        out = template.clone()
        out[:C] = old
        return out

    def pad(x):
        return torch.cat([x, x.new_zeros((new_capacity - C,) + x.shape[1:])])

    new_map = GaussianMap(
        params={k: merge(gmap.params[k], fresh.params[k]) for k in gmap.params},
        obj_prob=merge(gmap.obj_prob, fresh.obj_prob),
        kf_idx=pad(gmap.kf_idx), nr_obs=pad(gmap.nr_obs), active=pad(gmap.active),
        max_radii2d=pad(gmap.max_radii2d),
        xyz_grad_accum=pad(gmap.xyz_grad_accum), denom=pad(gmap.denom),
    )
    new_adam = AdamState(mu={k: pad(v) for k, v in adam.mu.items()},
                         nu={k: pad(v) for k, v in adam.nu.items()}, step=adam.step)
    return new_map, new_adam
