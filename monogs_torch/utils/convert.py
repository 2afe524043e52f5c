"""Carry the JAX package's map, frames and mapper state across as the
port's tensors, so both packages can compute on identical inputs. Each
function takes any object with the JAX type's fields as arrays (a
monogs_tpu value, for one) and imports nothing of the JAX package."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..models.gaussian_map import PARAM_KEYS, GaussianMap
from ..models.optim import AdamState
from ..slam.camera import Frame, Window
from ..slam.mapper import MapperState, PoseAdam


def _t(x, device, dtype=None) -> torch.Tensor:
    return torch.as_tensor(np.array(x), dtype=dtype, device=device)


def params_from_numpy(params: dict, device="cuda") -> dict:
    """Map parameters (arrays under PARAM_KEYS) -> float32 tensors."""
    return {k: _t(params[k], device, torch.float32) for k in PARAM_KEYS}


def frame_from_numpy(frame, device="cuda") -> Frame:
    """Frame's fields as arrays -> the port's Frame, dtypes kept (stacked
    frames keep their leading window axis)."""
    return Frame(**{f: _t(getattr(frame, f), device) for f in Frame._fields})


def mapper_state_from_numpy(state, device="cuda", seed: int = 0) -> MapperState:
    """A JAX MapperState's leaves -> the port's MapperState: the map's
    fields, the Adam moments, the window's frames and valid mask, the pose
    Adam and nr_iters. The JAX key has no torch counterpart; the port's
    rng is a torch.Generator seeded with `seed`."""
    g = state.gmap
    gmap = GaussianMap(
        params=params_from_numpy(g.params, device),
        **{f: _t(getattr(g, f), device) for f in GaussianMap._fields if f != "params"})
    adam = AdamState(mu=params_from_numpy(state.adam.mu, device),
                     nu=params_from_numpy(state.adam.nu, device),
                     step=_t(state.adam.step, device, torch.int32))
    window = Window(frames=frame_from_numpy(state.window.frames, device),
                    valid=_t(state.window.valid, device, torch.bool))
    pose_adam = PoseAdam(*(_t(x, device) for x in state.pose_adam))
    return MapperState(gmap=gmap, adam=adam, window=window, pose_adam=pose_adam,
                       nr_iters=_t(state.nr_iters, device, torch.int32),
                       rng=torch.Generator(device).manual_seed(seed))


def slam_from_numpy(src, slam, device="cuda"):
    """Set a port `SLAM`'s state to another SLAM's (a monogs_tpu one, for
    one): the mapper state, the derived entry capacities, and the host
    bookkeeping (poses, exposures, frames, visibility, the keyframe list
    and window slots, the prune and window flags, the probe counters), so
    that both take their next frame from the same point. -> slam."""
    slam.state = mapper_state_from_numpy(src.state, device)
    slam.tcfg = dataclasses.replace(slam.tcfg, entry_capacity=src.tcfg.entry_capacity)
    slam.mcfg = dataclasses.replace(slam.mcfg, entry_capacity=src.mcfg.entry_capacity)

    def pose(p):
        return tuple(np.array(x) for x in p)

    slam.est_poses = {i: pose(p) for i, p in src.est_poses.items()}
    slam._raw_poses = {i: pose(p) for i, p in src._raw_poses.items()}
    slam.gt_poses = {i: pose(p) for i, p in src.gt_poses.items()}
    slam.exposures = {i: tuple(float(np.asarray(x)) for x in e)
                      for i, e in src.exposures.items()}
    slam.frames = {i: frame_from_numpy(f, device) for i, f in src.frames.items()}
    slam.vis_dict = {i: _t(v, device, torch.bool) for i, v in src.vis_dict.items()}
    slam.kf_list = list(src.kf_list)
    slam.kf_history = set(src.kf_history)
    slam._window_slots = (None if src._window_slots is None
                          else list(src._window_slots))
    for name in ("is_window_full", "first_time_pruned", "median_depth", "_cap_bumps",
                 "_probe_counter"):
        setattr(slam, name, getattr(src, name))
    return slam
