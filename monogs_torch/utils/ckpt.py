"""Checkpoint and resume of the whole SLAM state (port of
monogs_tpu/utils/ckpt.py, with torch.save where the JAX package uses
orbax).

A checkpoint is a directory:
  state.pt          the MapperState flattened into named CPU tensors (the
                    map, the Adam moments, the keyframe window, the pose
                    Adam, the iteration count) and the state of its random
                    generator, `MapperState.rng` (`Generator.get_state`), so
                    a resumed run draws what the uninterrupted one draws;
                    loaded with `torch.load(weights_only=True)`: no pickled
                    objects;
  host.json         the host bookkeeping: keyframe list and history, the
                    state's map capacity and object count (for a cold
                    restore), window and prune flags, median depth, the
                    estimated, raw and ground-truth poses, the exposures,
                    the visibility keys, the derived entry capacities and the
                    re-probe counters;
  visibility.npz    the keyframes' visibility masks.

It is written into <path>.tmp and renamed into place (the previous one
moved aside to <path>.old, then removed), so a process that dies while
writing leaves the previous checkpoint whole; `load_checkpoint` reads
<path>.old when <path> is missing (a death between the two renames).
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil

import numpy as np
import torch


def state_tensors(state, prefix: str = "") -> dict:
    """Every tensor of a (nested NamedTuple / dict) state by dotted name;
    the random generator is not a tensor and is left out."""
    out = {}
    if isinstance(state, torch.Tensor):
        out[prefix] = state
    elif isinstance(state, dict):
        for k, v in state.items():
            out.update(state_tensors(v, f"{prefix}.{k}" if prefix else k))
    elif isinstance(state, tuple) and hasattr(state, "_fields"):
        for k, v in zip(state._fields, state):
            out.update(state_tensors(v, f"{prefix}.{k}" if prefix else k))
    return out


def _rebuild(template, flat: dict, prefix: str = ""):
    """`template` with each tensor replaced by flat[its name], which must
    have the template's shape and dtype."""
    if isinstance(template, torch.Tensor):
        if prefix not in flat:
            raise ValueError(f"checkpoint: no tensor {prefix!r}")
        x = flat.pop(prefix)
        if x.shape != template.shape or x.dtype != template.dtype:
            raise ValueError(f"checkpoint: {prefix} is {tuple(x.shape)} {x.dtype}, the "
                             f"state needs {tuple(template.shape)} {template.dtype}")
        return x
    if isinstance(template, dict):
        return {k: _rebuild(v, flat, f"{prefix}.{k}" if prefix else k)
                for k, v in template.items()}
    if isinstance(template, tuple) and hasattr(template, "_fields"):
        return type(template)(*(_rebuild(v, flat, f"{prefix}.{k}" if prefix else k)
                                for k, v in zip(template._fields, template)))
    return template


def _poses(poses: dict) -> dict:
    return {str(k): [np.asarray(R).tolist(), np.asarray(t).tolist()]
            for k, (R, t) in poses.items()}


def _unposes(d: dict) -> dict:
    return {int(k): (np.asarray(R, np.float32), np.asarray(t, np.float32))
            for k, (R, t) in d.items()}


def save_checkpoint(path: str, slam) -> None:
    """Write the SLAM's state and bookkeeping to the directory `path`.
    The state must be the one of the keyframe list (no keyframe event in
    flight): the restored window frames are read by slot in that order."""
    if slam._window_slots != slam.kf_list:
        raise RuntimeError(f"checkpoint: the state's window holds keyframes "
                           f"{slam._window_slots}, the keyframe list is {slam.kf_list}")
    state = slam.read_state()
    flat = {k: v.detach().cpu() for k, v in state_tensors(state).items()}
    flat["rng"] = state.rng.get_state()
    host = {
        "kf_list": list(slam.kf_list),
        "kf_history": sorted(slam.kf_history),
        "map_capacity": state.gmap.capacity,
        "nr_objects": int(state.gmap.obj_prob.shape[1]),
        "is_window_full": slam.is_window_full,
        "first_time_pruned": slam.first_time_pruned,
        "median_depth": float(slam.median_depth),
        "est_poses": _poses(slam.est_poses),
        "gt_poses": _poses(slam.gt_poses),
        "raw_poses": _poses(slam._raw_poses),
        "exposures": {str(k): [float(a), float(b)] for k, (a, b) in slam.exposures.items()},
        "vis_keys": [int(k) for k in slam.vis_dict],
        "entry_capacity": [slam.tcfg.entry_capacity, slam.mcfg.entry_capacity],
        "counters": [slam._cap_bumps, slam._probe_counter],
    }
    vis = {str(k): v.cpu().numpy() for k, v in slam.vis_dict.items()}

    path = os.path.normpath(path)
    tmp, old = path + ".tmp", path + ".old"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    torch.save(flat, os.path.join(tmp, "state.pt"))
    with open(os.path.join(tmp, "host.json"), "w") as f:
        json.dump(host, f)
    np.savez(os.path.join(tmp, "visibility.npz"), **vis)
    if os.path.exists(path):
        shutil.rmtree(old, ignore_errors=True)
        os.rename(path, old)
    os.rename(tmp, path)
    shutil.rmtree(old, ignore_errors=True)


def load_checkpoint(path: str, slam) -> None:
    """Restore a checkpoint into a SLAM built on the same dataset and
    configs. With `slam.state` None (a fresh process) the state's template
    is built from host.json and the dataset's frame 0; otherwise the
    current state is the template. Every tensor must match it in name,
    shape and dtype."""
    from ..slam.camera import make_frame, window_from_list, window_get
    from ..slam.mapper import init_mapper_state

    path = os.path.normpath(path)
    if not os.path.isdir(path) and os.path.isdir(path + ".old"):
        path += ".old"
    with open(os.path.join(path, "host.json")) as f:
        host = json.load(f)
    dev = slam.device
    template = slam.state
    if template is None:
        d = slam.dataset[0]
        frame = make_frame(0, d["rgb"], d.get("depth"), d["pose"], mask=d.get("mask"),
                           segmentation=d.get("segmentation"), device=dev)
        template = init_mapper_state(host["map_capacity"], host["nr_objects"],
                                     window_from_list([frame], slam._window_capacity()),
                                     seed=slam.scfg.seed)
    flat = torch.load(os.path.join(path, "state.pt"), weights_only=True, map_location=dev)
    rng = torch.Generator(dev)
    rng.set_state(flat.pop("rng").cpu())
    state = _rebuild(template, flat)._replace(rng=rng)
    if flat:
        raise ValueError(f"checkpoint: tensors the state does not have: {sorted(flat)}")
    slam.state = state

    slam.kf_list = list(host["kf_list"])
    slam.kf_history = set(host["kf_history"])
    slam.is_window_full = host["is_window_full"]
    slam.first_time_pruned = host["first_time_pruned"]
    slam.median_depth = host["median_depth"]
    slam.est_poses = _unposes(host["est_poses"])
    slam.gt_poses = _unposes(host["gt_poses"])
    slam._raw_poses = _unposes(host["raw_poses"])
    slam.exposures = {int(k): (a, b) for k, (a, b) in host["exposures"].items()}
    tcap, mcap = host["entry_capacity"]
    slam.tcfg = dataclasses.replace(slam.tcfg, entry_capacity=tcap)
    slam.mcfg = dataclasses.replace(slam.mcfg, entry_capacity=mcap)
    slam._cap_bumps, slam._probe_counter = host["counters"][:2]
    with np.load(os.path.join(path, "visibility.npz")) as vis:
        slam.vis_dict = {int(k): torch.as_tensor(vis[k], device=dev) for k in vis.files}
    # The window is in keyframe-list slot order (save_checkpoint checks
    # it), so keyframe events go on updating it by permutation.
    for slot, idx in enumerate(slam.kf_list):
        slam.frames[idx] = window_get(state.window, slot)
    slam._window_slots = list(slam.kf_list)
