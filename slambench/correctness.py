"""The comparison that decides `correct`: what the timed path produced,
held against the plain reference (`reference/`), which recomputes it from
the benchmark's own frames and from the program's state at that point.

Numbers, each against the limit of its cell (`limits/<cell>.json`):
- dropped_entries: the most (tile, Gaussian) entries any binning of the
  run dropped, set-up and window, by the program's own count; the
  reference lists every entry (limit 0: nothing dropped).
- render_err: for a sample of the window's tracked frames, the depth and
  opacity images the tracker rendered at the pose it returned, against the
  reference's render of the same map at that pose: |port - ref| / |ref|
  over both images, the largest over the sample (projection, tile lists,
  slab_fwd).
- track_grad_err: for every tracked frame of the window, the gradient with
  respect to the pose delta that the tracker's first iteration handed its
  Adam update, against the reference's gradient of the tracking loss at the
  same pose: |port - ref| for rho and for theta, over the larger of that
  frame's |ref| and the median |ref| of the same leaf over the window's
  frames, the largest (slab_bwd through the pose retraction). A frame that
  starts near its optimum has a gradient some ten times below the others,
  and the program's rounding (its 20-bit depth key) is a gap of fixed size,
  so over its own |ref| alone such a frame reads ten times higher.
- track_step_err: the change the tracker's first step made on those frames,
  against one step of the reference's Adam from a fresh state with the
  reference's gradient: |port - ref| / |ref| over the components kept, the
  largest over the sample (the tracker's optimiser step and retraction).
  The pose's rho and theta are read back from the pose the step made; a
  component is kept where its reference gradient is at least STEP_FLOOR of
  its leaf's norm (Adam's first step is the learning rate times the
  gradient's sign, and a gradient within track_grad_err's limit cannot
  flip the sign of such a component). The exposure's a and b are compared
  by the size of their step alone, where their reference gradient is at
  least EXPOSURE_FLOOR times Adam's eps (the step is then the learning rate
  to 1e-4): the exposure's gradient sums L1 residuals of opposite signs, so
  its sign is not determined as the pose's is.
- map_grad_err: the raw gradients of the first mapping iteration of a
  keyframe event (its tile bins made at that state), against the
  reference's gradients of the window's mapping loss: |port - ref| / |ref|
  per leaf (the five map parameters, the keyframes' rho and theta), the
  largest over the leaves whose reference gradient is not nought to
  rounding (norm at least 1e-3 of the median leaf's) (slab_bwd, the
  relayout, the window's feature gather).
- map_step_err: the change of the map's parameters that iteration made,
  against one step of the reference's Adam (reference/adam.py) from the
  same moments with the reference's gradients: |port - ref| / |ref| per
  leaf, over the same leaves (the optimiser's step).
- ate_m: the trajectory error of every frame the run tracked against the
  ground truth the benchmark generated (reference/ate.py), against the
  limit its configuration states.
"""

from __future__ import annotations

import random
import time

import numpy as np
import torch

from .reference import adam as ref_adam
from .reference import ate as ref_ate
from .reference import losses as ref_losses
from .reference import render as ref_render

LEAF_FLOOR = 1e-3
STEP_FLOOR = 5e-2
EXPOSURE_FLOOR = 1e4


def rel(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double().reshape(-1), b.double().reshape(-1)
    return float(torch.linalg.vector_norm(a - b) / torch.clamp_min(torch.linalg.vector_norm(b), 1e-30))


def _gt(frames: dict, idx: int, use_depth: bool) -> dict:
    d = frames["depth"][idx]
    return {"rgb": frames["rgb"][idx], "mask": frames["mask"][idx],
            "depth": d if use_depth else torch.zeros_like(d)}


def first_step_err(rec: dict, g: dict) -> float:
    """track_step_err of one tracked frame, `g` the reference's gradient."""
    cfg, st = rec["cfg"], rec["step"]
    if st is None or "R1" not in st:
        return float("inf")
    rho, theta = ref_render.pose_delta(rec["R0"], rec["t0"], st["R1"], st["t1"])
    got, want = [], []
    for k, lr, port in (("rho", cfg.lr_trans, rho), ("theta", cfg.lr_rot, theta)):
        gk = g[k].double().reshape(-1)
        keep = gk.abs() >= STEP_FLOOR * torch.linalg.vector_norm(gk)
        zero = torch.zeros_like(gk)
        want.append(ref_adam.adam_delta(gk, zero, zero, 0, lr, eps=cfg.adam_eps)[keep])
        got.append(port.double().reshape(-1)[keep])
    for k in ("ea", "eb"):
        gk = torch.as_tensor(g[k]).double().reshape(-1)
        keep = gk.abs() >= EXPOSURE_FLOOR * cfg.adam_eps
        zero = torch.zeros_like(gk)
        want.append(ref_adam.adam_delta(gk, zero, zero, 0, cfg.lr_exposure,
                                        eps=cfg.adam_eps).abs()[keep])
        got.append(torch.as_tensor(st["d_" + k]).double().reshape(-1).abs()[keep])
    return rel(torch.cat(got), torch.cat(want))


def grad_gap(ports: list, refs: list) -> float:
    """track_grad_err: `ports` the program's (rho, theta) gradients of the
    frames, `refs` the reference's."""
    worst = 0.0
    for j, k in enumerate(("rho", "theta")):
        norms = [float(torch.linalg.vector_norm(g[k].double())) for g in refs]
        scale = max(float(np.median(norms)), 1e-30)
        for port, g, norm in zip(ports, refs, norms):
            gap = torch.linalg.vector_norm(port[j].double().reshape(-1)
                                           - g[k].double().reshape(-1))
            worst = max(worst, float(gap) / max(norm, scale))
    return worst


def track_numbers(tracks: list, picked: list, frames: dict, cam, iso: bool, use_depth: bool,
                  precision: str = "fp32") -> dict:
    """track_grad_err over every captured tracked frame; render_err and
    track_step_err over the frames `picked` (indices into `tracks`)."""
    r_err = s_err = 0.0
    ports, refs = [], []
    for i, rec in enumerate(tracks):
        cfg, tile = rec["cfg"], rec["cfg"].tile_size
        if i in picked:
            img = ref_losses.render_at(rec["params"], rec["active"], iso, rec["R"], rec["t"],
                                       cam, tile, precision)
            port = torch.stack([rec["depth"], rec["opacity"]], -1)
            r_err = max(r_err, rel(port, img[..., 3:5]))
        if rec["grads"] is None:
            return {"render_err": r_err, "track_grad_err": float("inf"),
                    "track_step_err": float("inf")}
        g = ref_losses.tracking_grads(
            rec["params"], rec["active"], iso, _gt(frames, int(rec["frame_idx"]), use_depth),
            rec["R0"], rec["t0"], rec["ea0"], rec["eb0"], cam, tile,
            opacity_threshold=cfg.opacity_threshold, exposure_reg=cfg.exposure_reg,
            precision=precision)
        ports.append(rec["grads"])
        refs.append(g)
        if i in picked:
            s_err = max(s_err, first_step_err(rec, g))
    g_err = grad_gap(ports, refs) if refs else float("inf")
    return {"render_err": r_err, "track_grad_err": g_err, "track_step_err": s_err}


def map_numbers(maps: list, frames: dict, cam, iso: bool, use_depth: bool,
                precision: str = "fp32") -> dict:
    """map_grad_err and map_step_err over the captured mapping iterations."""
    err = step_err = 0.0
    for rec in maps:
        cfg = rec["cfg"]
        slots = [i for i in range(rec["valid"].shape[0]) if bool(rec["valid"][i])]
        gts = [_gt(frames, int(rec["frame_idx"][i]), use_depth) for i in slots]
        ref = ref_losses.mapping_grads(
            rec["params"], rec["active"], iso,
            [dict(R=rec["R"][i], t=rec["t"][i], ea=rec["ea"][i], eb=rec["eb"][i], **gt)
             for i, gt in zip(slots, gts)],
            cam, cfg.tile_size, lambda_depth=cfg.lambda_depth,
            precision=precision)
        port = dict(rec["grads"])
        port["rho"], port["theta"] = port["rho"][slots], port["theta"][slots]
        norms = {k: float(torch.linalg.vector_norm(ref[k].double())) for k in ref}
        floor = LEAF_FLOOR * float(np.median(list(norms.values())))
        kept = [k for k in ref if norms[k] >= floor]
        for k in kept:
            err = max(err, rel(port[k], ref[k]))
        lrs = {"xyz": ref_adam.position_lr(int(rec["nr_iters"]),
                                           cfg.position_lr_init * cfg.spatial_lr_scale,
                                           cfg.position_lr_final * cfg.spatial_lr_scale,
                                           cfg.position_lr_max_steps),
               "rgb": cfg.feature_lr, "log_scales": cfg.scaling_lr * cfg.spatial_lr_scale,
               "quats": cfg.rotation_lr, "opacity_logit": cfg.opacity_lr}
        p0 = rec["params"]
        new = ref_adam.adam_step(p0, {k: ref[k] for k in p0}, rec["mu"], rec["nu"],
                                 int(rec["adam_step"]), lrs, rec["active"])
        for k in kept:
            if k in p0:
                step_err = max(step_err, rel(rec["stepped"][k] - p0[k], new[k] - p0[k]))
    return {"map_grad_err": err, "map_step_err": step_err}


def ate_number(est_poses: dict, gt_poses: np.ndarray, align: str) -> float:
    idxs = sorted(est_poses)
    est = np.zeros((len(idxs), 4, 4))
    for n, i in enumerate(idxs):
        R, t = est_poses[i]
        est[n, :3, :3], est[n, :3, 3], est[n, 3, 3] = R, t, 1.0
    return ref_ate.ate_rmse(est, gt_poses[idxs], align)


def sample(seq: list, k: int, seed: int) -> list:
    """k of seq drawn from the seed, in their order."""
    if len(seq) <= k:
        return list(seq)
    keep = sorted(random.Random(seed).sample(range(len(seq)), k))
    return [seq[i] for i in keep]


def dropped_entries(dropped: list) -> int:
    """The most entries one of the run's binnings dropped (one host read)."""
    return int(torch.stack(dropped).max()) if dropped else 0


def numbers(cap, frames: dict, cam, iso: bool, use_depth: bool, checks: dict, seed: int,
            precision: str = "fp32") -> tuple[dict, float]:
    """The reference's numbers for a run's captures. -> (numbers, seconds)."""
    t0 = time.perf_counter()
    picked = sample(list(range(len(cap.tracks))), int(checks["track_frames"]), seed)
    out = track_numbers(cap.tracks, picked, frames, cam, iso, use_depth, precision)
    maps = sample(cap.maps, int(checks["map_events"]), seed + 1)
    out.update(map_numbers(maps, frames, cam, iso, use_depth, precision) if maps
               else {"map_grad_err": float("inf"), "map_step_err": float("inf")})
    return out, time.perf_counter() - t0
