"""What the benchmark keeps of the timed path for the correctness check and
the kernel sampling: wrappers around the program's own functions,
installed for the window and taken off after it.

- `track_frame` (as `slam.system` calls it): the map, the frame's initial
  pose and exposure as the tracker receives them, the first iteration's
  gradients and its exposure step (through the tracker's Adam update,
  which receives the one and returns the other), the pose that step made
  (the pose retraction that follows the update), and the tracked pose and
  the depth and opacity it rendered there.
- `_mapping_iter` (as `mapping_span` calls it): the state, the raw
  gradients and the stepped parameters of the first iteration of each
  keyframe event's first segment, where the tile bins were made at that
  very state.
- `kernels.slab_fwd` / `slab_bwd` (the traced cycle of a traced run):
  every launch counted by phase, some launches kept with their inputs and
  timed with CUDA events.
- `tile_bin` (as the tracker, the mapper and the renderer call it): the
  entries each binning dropped, over set-up and the window.
Nothing here reads a device value on the host while the window runs.
"""

from __future__ import annotations

import contextlib

import torch

MAP_KEYS = ("xyz", "rgb", "log_scales", "quats", "opacity_logit")


def _clone_params(params: dict) -> dict:
    return {k: params[k].detach().clone() for k in MAP_KEYS}


class Captures:
    def __init__(self):
        self.tracks: list[dict] = []
        self.maps: list[dict] = []
        self._first_grads = None
        self._first_step = None
        self._want_step = False
        self._want_map = True

    def next_keyframe_event(self):
        """Keep the next mapping iteration that starts a segment."""
        self._want_map = True


@contextlib.contextmanager
def install(cap: Captures):
    from monogs_torch.ops import lie
    from monogs_torch.slam import mapper, system, tracker

    orig_track, orig_adam, orig_iter = system.track_frame, tracker._adam4_update, mapper._mapping_iter
    orig_retract = lie.apply_pose_delta
    seen_bins = {"last": None}

    def adam_hook(grads, *args, **kwargs):
        first = cap._first_grads is None
        if first:
            cap._first_grads = tuple(g.detach().clone() for g in grads)
        upd, st = orig_adam(grads, *args, **kwargs)
        if first:
            cap._first_step = {"d_ea": upd[2].detach().clone(), "d_eb": upd[3].detach().clone()}
            cap._want_step = True
        return upd, st

    def retract_hook(R, t, rho, theta):
        out = orig_retract(R, t, rho, theta)
        if cap._want_step:        # the retraction right after the first update
            cap._want_step = False
            cap._first_step.update(R1=out[0].detach().clone(), t1=out[1].detach().clone())
        return out

    def track_hook(params, active, frame, intr, cfg, *args, **kwargs):
        rec = {"params": _clone_params(params), "active": active.clone(),
               "frame_idx": frame.frame_idx, "R0": frame.R.clone(), "t0": frame.t.clone(),
               "ea0": frame.exposure_a.clone(), "eb0": frame.exposure_b.clone(), "cfg": cfg}
        cap._first_grads, cap._first_step, cap._want_step = None, None, False
        res = orig_track(params, active, frame, intr, cfg, *args, **kwargs)
        rec.update(grads=cap._first_grads, step=cap._first_step, R=res.R, t=res.t,
                   depth=res.render_depth, opacity=res.render_opacity, n_iters=res.n_iters)
        cap._first_grads, cap._first_step, cap._want_step = None, None, False
        cap.tracks.append(rec)
        return res

    def iter_hook(state, intr, cfg, init, bins, gt_tiles, *args, **kwargs):
        fresh = bins is not seen_bins["last"]
        seen_bins["last"] = bins
        keep = cap._want_map and fresh and not init
        rec = None
        if keep:
            cap._want_map = False
            f, w = state.window.frames, state.window
            rec = {"params": _clone_params(state.gmap.params), "active": state.gmap.active.clone(),
                   "R": f.R.clone(), "t": f.t.clone(), "ea": f.exposure_a.clone(),
                   "eb": f.exposure_b.clone(), "frame_idx": f.frame_idx.clone(),
                   "valid": w.valid.clone(), "cfg": cfg, "nr_iters": state.nr_iters.clone(),
                   "mu": {k: state.adam.mu[k].clone() for k in MAP_KEYS},
                   "nu": {k: state.adam.nu[k].clone() for k in MAP_KEYS},
                   "adam_step": state.adam.step.clone()}
        out = orig_iter(state, intr, cfg, init, bins, gt_tiles, *args, **kwargs)
        if rec is not None:
            grads = out[2]
            rec["grads"] = {**{k: grads[0][k].detach().clone() for k in MAP_KEYS},
                            "rho": grads[1].detach().clone(), "theta": grads[2].detach().clone()}
            rec["stepped"] = _clone_params(out[0].gmap.params)
            cap.maps.append(rec)
        return out

    system.track_frame, tracker._adam4_update, mapper._mapping_iter = track_hook, adam_hook, iter_hook
    lie.apply_pose_delta = retract_hook
    try:
        yield cap
    finally:
        system.track_frame, tracker._adam4_update, mapper._mapping_iter = orig_track, orig_adam, orig_iter
        lie.apply_pose_delta = orig_retract


@contextlib.contextmanager
def install_overflow(dropped: list):
    """Append each binning's dropped-entry count (a device scalar) to
    `dropped`: every `tile_bin` the tracker, the mapper and the renderer
    call."""
    from monogs_torch.ops import render
    from monogs_torch.slam import mapper, tracker

    mods = (tracker, mapper, render)
    orig = [m.tile_bin for m in mods]

    def wrap(fn):
        def tile_bin(*args, **kwargs):
            bins = fn(*args, **kwargs)
            dropped.append(bins.overflow)
            return bins
        return tile_bin

    for m, fn in zip(mods, orig):
        m.tile_bin = wrap(fn)
    try:
        yield dropped
    finally:
        for m, fn in zip(mods, orig):
            m.tile_bin = fn


class KernelSamples:
    """Launch counts of the slab kernels by phase ("track": one image,
    "map": a keyframe window), and up to `keep` launches of each kernel
    and phase kept with their inputs, every `every`-th one."""

    def __init__(self, keep: int = 6, every: int = 25):
        self.keep, self.every = keep, every
        self.counts: dict = {}
        self.samples: list[dict] = []
        self.on = False


@contextlib.contextmanager
def install_kernel_sampling(ks: KernelSamples):
    from monogs_torch.ops import kernels

    orig = {"slab_fwd": kernels.slab_fwd, "slab_bwd": kernels.slab_bwd}

    def wrap(name):
        fn = orig[name]

        def launcher(feats_cm, pstart_blk, counts, order, *rest):
            if not ks.on:
                return fn(feats_cm, pstart_blk, counts, order, *rest)
            key = (name, "track" if feats_cm.shape[0] == 1 else "map")
            n = ks.counts.get(key, 0)
            ks.counts[key] = n + 1
            kept = sum(1 for s in ks.samples if s["key"] == key)
            if n % ks.every or kept >= ks.keep:
                return fn(feats_cm, pstart_blk, counts, order, *rest)
            ev0 = torch.cuda.Event(enable_timing=True)
            ev1 = torch.cuda.Event(enable_timing=True)
            ev0.record()
            out = fn(feats_cm, pstart_blk, counts, order, *rest)
            ev1.record()
            rec = {"key": key, "ev": (ev0, ev1), "feats": feats_cm.clone(),
                   "pstart": pstart_blk.clone(), "counts": counts.clone(), "cfg": rest[-1]
                   if name == "slab_bwd" else rest[0]}
            if name == "slab_fwd":
                rec["K"], rec["touched"] = rest[1], bool(rest[2])
            else:
                rec["baux"] = rest[0].clone()
            ks.samples.append(rec)
            return out

        launcher.launches, launcher.by_stream = 0, {}
        return launcher

    kernels.slab_fwd, kernels.slab_bwd = wrap("slab_fwd"), wrap("slab_bwd")
    try:
        yield ks
    finally:
        kernels.slab_fwd, kernels.slab_bwd = orig["slab_fwd"], orig["slab_bwd"]
