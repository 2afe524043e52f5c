"""Kubric parser (port of monogs_tpu/data/kubric.py): camera poses in
metadata.json (positions and wxyz quaternions, with the OpenGL-style flip
of the camera's y and z axes), rgba/*.png colour, depth/*.tiff depth and
segmentation/*.png object ids. The PNGs are decoded by the port's own
codec, the TIFF depth by OpenCV as in the JAX package (without OpenCV the
constructor raises ImportError). A colour segmentation image keeps the channel the JAX package
keeps, OpenCV's first, which is blue: channel 2 in the codec's RGB order."""

from __future__ import annotations

import glob
import json
import os

import numpy as np

from ..utils.images import read_image
from .base import BaseDataset, cv2_for, digit_key, quat_wxyz_to_rotmat, segmentation_ids


class KubricDataset(BaseDataset):
    def __init__(self, config: dict):
        super().__init__(config)
        cv2_for("decoding Kubric's TIFF depth")   # fail here, not at the first frame
        self.root = os.path.expanduser(config["Dataset"]["dataset_path"])
        with open(os.path.join(self.root, "metadata.json")) as f:
            metadata = json.load(f)["camera"]
        flip = np.diag([1.0, -1.0, -1.0])
        self.poses_w2c = []
        for position, quat in zip(metadata["positions"], metadata["quaternions"]):
            T = np.eye(4)
            T[:3, :3] = quat_wxyz_to_rotmat(quat) @ flip
            T[:3, 3] = position
            self.poses_w2c.append(np.linalg.inv(T))
        self.color_paths = sorted(glob.glob(f"{self.root}/rgba/*.png"), key=digit_key)
        self.depth_paths = sorted(glob.glob(f"{self.root}/depth/*.tiff"), key=digit_key)
        self.segmentation_paths = sorted(glob.glob(f"{self.root}/segmentation/*.png"),
                                         key=digit_key)

    def __len__(self):
        return len(self.color_paths)

    def __getitem__(self, idx: int) -> dict:
        rgba = read_image(self.color_paths[idx], "unchanged")
        rgb = (rgba[..., :3] / 255.0).astype(np.float32)
        depth = read_image(self.depth_paths[idx], "unchanged").astype(np.float32)
        seg = segmentation_ids(read_image(self.segmentation_paths[idx], "unchanged"))
        return {
            "rgb": rgb,
            "depth": depth / self.depth_scale,
            "pose": self.poses_w2c[idx].astype(np.float32),
            "mask": self.mask_from_segmentation(seg),
            "segmentation": seg,
        }
