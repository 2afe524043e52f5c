"""DAVIS video-segmentation parser (port of monogs_tpu/data/davis.py):
monocular, rgb/*.jpg and segmentation/*.png, no depth and no ground-truth
poses (identity placeholders). The JPEG is decoded by OpenCV as in the JAX
package (without OpenCV the constructor raises ImportError), the
segmentation PNG (a palette image, expanded to colour) by the port's own
codec."""

from __future__ import annotations

import glob
import os

import numpy as np

from ..utils.images import read_image
from .base import BaseDataset, cv2_for, digit_key, segmentation_ids


class DavisDataset(BaseDataset):
    def __init__(self, config: dict):
        super().__init__(config)
        cv2_for("decoding DAVIS's JPEG rgb")   # fail here, not at the first frame
        self.root = os.path.expanduser(config["Dataset"]["dataset_path"])
        self.color_paths = sorted(glob.glob(f"{self.root}/rgb/*.jpg"), key=digit_key)
        self.segmentation_paths = sorted(glob.glob(f"{self.root}/segmentation/*.png"),
                                         key=digit_key)
        self.has_depth = False

    def __len__(self):
        return len(self.color_paths)

    def __getitem__(self, idx: int) -> dict:
        rgb = (read_image(self.color_paths[idx], "color") / 255.0).astype(np.float32)
        seg = segmentation_ids(read_image(self.segmentation_paths[idx], "unchanged"))
        return {
            "rgb": rgb,
            "depth": None,
            "pose": np.eye(4, dtype=np.float32),  # no ground-truth trajectory
            "mask": self.mask_from_segmentation(seg),
            "segmentation": seg,
        }
