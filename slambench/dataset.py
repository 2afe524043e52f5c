"""The benchmark's frames: the frozen room, its Gaussians in an order drawn
from the seed, rendered on the card by the plain renderer, kept on the
device, and handed to the SLAM system through the dataset interface it
reads (`len`, `[idx]` -> a dict of rgb, depth, pose, mask; `intrinsics`)."""

from __future__ import annotations

import numpy as np
import torch

from . import scene
from .reference import render as rr

GT_TILE = 16          # the synthetic dataset's render tile
COVERED = 0.5         # a pixel is in the frame's mask above this opacity


def camera_of(config: dict) -> rr.Camera:
    c = config["Dataset"]["Calibration"]
    return rr.Camera(float(c["fx"]), float(c["fy"]), float(c["cx"]), float(c["cy"]),
                     int(c["width"]), int(c["height"]))


def scene_arrays(config: dict, seed: int) -> list:
    """The configuration's room (its own scene seed), its Gaussians listed in
    an order drawn from `seed`: every seed gives the same scene and the same
    work, in another order."""
    syn = config["Dataset"]["synthetic"]
    n = int(syn["n_gaussians"])
    arrays = scene.room_scene(n, scene.numpy_seed(int(syn["seed"])))
    order = np.random.RandomState(scene.numpy_seed(seed)).permutation(n)
    return [np.asarray(x)[order] for x in arrays]


@torch.no_grad()
def render_frames(config: dict, seed: int, n_frames: int, device) -> dict:
    """The orbit's first n_frames frames of the room on `device`:
    {"rgb" (n, H, W, 3), "depth" (n, H, W), "mask" (n, H, W) bool,
    "poses" (n, 4, 4) float64 numpy world-to-camera}."""
    syn = config["Dataset"]["synthetic"]
    cam = camera_of(config)
    means, scales, quats, opac, rgb = (
        torch.as_tensor(x, dtype=torch.float32, device=device)
        for x in scene_arrays(config, seed))
    poses = np.stack(scene.orbit_trajectory(n_frames, float(syn["motion_scale"])))
    out = {"rgb": torch.empty((n_frames, cam.height, cam.width, 3), device=device),
           "depth": torch.empty((n_frames, cam.height, cam.width), device=device),
           "mask": torch.empty((n_frames, cam.height, cam.width), dtype=torch.bool,
                               device=device),
           "poses": poses}
    P = torch.as_tensor(poses, dtype=torch.float32, device=device)
    for i in range(n_frames):
        proj = rr.project(means, scales, quats, opac, P[i, :3, :3], P[i, :3, 3], cam)
        img = rr.render(rr.features(proj, opac, rgb), rr.tile_lists(proj, cam, GT_TILE), cam)
        covered = img[..., 4] > COVERED
        out["rgb"][i] = torch.clamp(img[..., 0:3], 0.0, 1.0)
        out["depth"][i] = torch.where(covered, img[..., 3] / torch.clamp_min(img[..., 4], 1e-6),
                                      torch.zeros_like(img[..., 3]))
        out["mask"][i] = covered
    return out


class StreamDataset:
    """Frames already on the device; `use_depth` False hands no depth (the
    monocular sensor)."""

    def __init__(self, config: dict, frames: dict, intrinsics_cls):
        cam = camera_of(config)
        self.frames = frames
        self.use_depth = bool(config["Dataset"]["synthetic"].get("use_depth", True))
        self.intrinsics = intrinsics_cls(fx=cam.fx, fy=cam.fy, cx=cam.cx, cy=cam.cy,
                                         width=cam.width, height=cam.height)
        self.nr_objects = 1
        self.poses32 = frames["poses"].astype(np.float32)

    def __len__(self):
        return len(self.poses32)

    def __getitem__(self, idx: int) -> dict:
        if not 0 <= idx < len(self):
            raise IndexError(idx)
        f = self.frames
        return {"rgb": f["rgb"][idx], "depth": f["depth"][idx] if self.use_depth else None,
                "pose": self.poses32[idx], "mask": f["mask"][idx], "segmentation": None}
