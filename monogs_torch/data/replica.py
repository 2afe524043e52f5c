"""Replica parser (port of monogs_tpu/data/replica.py): frames at
results/frame*.jpg and results/depth*.png, c2w poses (a row-major 4x4 a
line) in traj.txt, depth over png_depth_scale. The rgb is JPEG, decoded by
OpenCV as in the JAX package; without OpenCV the constructor raises
ImportError. The depth is PNG, decoded by the port's own codec."""

from __future__ import annotations

import glob
import os

import numpy as np

from ..utils.images import read_image
from .base import BaseDataset, cv2_for


class ReplicaDataset(BaseDataset):
    def __init__(self, config: dict):
        super().__init__(config)
        cv2_for("decoding Replica's JPEG rgb")   # fail here, not at the first frame
        self.root = os.path.expanduser(config["Dataset"]["dataset_path"])
        self.color_paths = sorted(glob.glob(os.path.join(self.root, "results/frame*.jpg")))
        self.depth_paths = sorted(glob.glob(os.path.join(self.root, "results/depth*.png")))
        traj = np.loadtxt(os.path.join(self.root, "traj.txt"))
        self.poses_w2c = [np.linalg.inv(traj[i].reshape(4, 4))
                          for i in range(len(self.color_paths))]

    def __len__(self):
        return len(self.color_paths)

    def __getitem__(self, idx: int) -> dict:
        rgb = read_image(self.color_paths[idx], "color")
        depth = read_image(self.depth_paths[idx], "unchanged")
        rgb = (rgb / 255.0).astype(np.float32)
        depth = depth.astype(np.float32) / self.depth_scale
        return {
            "rgb": rgb,
            "depth": depth,
            "pose": self.poses_w2c[idx].astype(np.float32),
            "mask": np.ones(depth.shape, bool),
            "segmentation": np.zeros(depth.shape, np.int32),
        }
