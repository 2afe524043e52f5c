"""Dataset base classes (port of monogs_tpu/data/base.py).

A frame is a plain dict {rgb (H, W, 3) float32 [0, 1], depth (H, W)
float32 or None, pose (4, 4) w2c, mask (H, W) bool, segmentation (H, W)
int32}, as numpy arrays, or as tensors on the SLAM device once
`PreloadedDataset(to_device=...)` has placed them there. The calibration,
with undistortion through OpenCV where a config says `distorted`, is
applied here, so the SLAM layer only sees pinhole images. The object ids
(static / dynamic / masked) drive the mask and segmentation channels.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..ops.graphics import Intrinsics


def cv2_for(what: str):
    """OpenCV, for the steps the port leaves to it as the JAX package does
    (undistortion and rectification maps, remap, SGBM); ImportError naming
    `what` where it is missing."""
    try:
        import cv2
    except ImportError as e:
        raise ImportError(f"{what} needs OpenCV (cv2), which is not installed") from e
    return cv2


def digit_key(f: str) -> int:
    """Sort key of a frame file: the digits of its name as one number."""
    return int("".join(filter(str.isdigit, os.path.basename(f))) or 0)


def quat_wxyz_to_rotmat(q) -> np.ndarray:
    """(w, x, y, z), not necessarily normalised -> (3, 3) rotation."""
    w, x, y, z = q
    n = w * w + x * x + y * y + z * z
    s = 0.0 if n == 0 else 2.0 / n
    return np.array([
        [1 - s * (y * y + z * z), s * (x * y - z * w), s * (x * z + y * w)],
        [s * (x * y + z * w), 1 - s * (x * x + z * z), s * (y * z - x * w)],
        [s * (x * z - y * w), s * (y * z + x * w), 1 - s * (x * x + y * y)],
    ])


def segmentation_ids(seg: np.ndarray) -> np.ndarray:
    """Object ids of a decoded segmentation image (RGB order): a colour
    image's blue channel, which is the channel OpenCV's BGR order puts
    first."""
    if seg.ndim == 3:
        seg = seg[..., 2]
    return seg.astype(np.int32)


class BaseDataset:
    def __init__(self, config: dict):
        self.config = config
        calib = config["Dataset"]["Calibration"]
        self.width = int(calib["width"])
        self.height = int(calib["height"])
        self.fx = float(calib["fx"])
        self.fy = float(calib["fy"])
        self.cx = float(calib["cx"])
        self.cy = float(calib["cy"])
        self.depth_scale = float(calib.get("depth_scale", 1.0))
        self.has_depth = bool(calib.get("depth_scale", None))

        self.dist_coeffs = None
        self.map1x = self.map1y = None
        if calib.get("distorted", False):
            cv2 = cv2_for("undistorting the images of a distorted calibration")
            self.dist_coeffs = np.array([
                calib.get("k1", 0.0), calib.get("k2", 0.0),
                calib.get("p1", 0.0), calib.get("p2", 0.0), calib.get("k3", 0.0),
            ])
            K = self.K_matrix()
            self.map1x, self.map1y = cv2.initUndistortRectifyMap(
                K, self.dist_coeffs, np.eye(3), K, (self.width, self.height),
                cv2.CV_32FC1)

        objects = config["Dataset"].get("Objects", {}) or {}
        self.static_objects_idxs = list(objects.get("static", []) or [])
        self.dynamic_objects_idxs = list(objects.get("dynamic", []) or [])
        self.masked_objects_idxs = list(objects.get("masked", []) or [])
        self.nr_objects = max(
            len(self.static_objects_idxs) + len(self.dynamic_objects_idxs), 1)

    def K_matrix(self) -> np.ndarray:
        return np.array([[self.fx, 0, self.cx], [0, self.fy, self.cy], [0, 0, 1]],
                        dtype=np.float64)

    @property
    def intrinsics(self) -> Intrinsics:
        return Intrinsics(fx=self.fx, fy=self.fy, cx=self.cx, cy=self.cy,
                          width=self.width, height=self.height)

    def undistort_rgb(self, rgb: np.ndarray) -> np.ndarray:
        if self.map1x is None:
            return rgb
        cv2 = cv2_for("undistorting the images of a distorted calibration")
        return cv2.remap(rgb, self.map1x, self.map1y, cv2.INTER_LINEAR)

    def mask_from_segmentation(self, segmentation: np.ndarray) -> np.ndarray:
        """False on the pixels of `masked` object ids, which every loss
        leaves out."""
        mask = np.ones(segmentation.shape, bool)
        for idx in self.masked_objects_idxs:
            mask &= segmentation != idx
        return mask

    def __len__(self):
        raise NotImplementedError

    def __getitem__(self, idx: int) -> dict:
        raise NotImplementedError


class PreloadedDataset:
    """Loads every frame once. With `to_device` (a torch device) the image
    arrays are placed there up front, so the frame loop pays no host-to-
    device copy per frame. Attribute access goes to the wrapped dataset."""

    def __init__(self, dataset, to_device=None):
        self._dataset = dataset
        self._frames = [dataset[i] for i in range(len(dataset))]
        if to_device is not None:
            self._frames = [
                {k: torch.as_tensor(v, device=to_device) if isinstance(v, np.ndarray)
                 else v for k, v in f.items()}
                for f in self._frames]

    def __getattr__(self, name):
        return getattr(self._dataset, name)

    def __len__(self):
        return len(self._frames)

    def __getitem__(self, idx: int) -> dict:
        return self._frames[idx]


def maybe_preload(dataset, config: dict, device="cuda"):
    """Dataset.preload: false | true (host memory) | "device" (the SLAM
    device's memory)."""
    mode = config.get("Dataset", {}).get("preload", False)
    if mode:
        return PreloadedDataset(dataset, to_device=device if mode == "device" else None)
    return dataset
