"""TUM RGB-D parser (port of monogs_tpu/data/tum.py).

The TUM association protocol: each rgb timestamp is matched to its nearest
depth and ground-truth pose timestamps (tolerance 0.08 s), the matches are
thinned to about 32 Hz, and the c2w quaternion poses become w2c. The
matching is vectorised (searchsorted over the sorted partner streams) and
gives the per-frame argmin scan's answers. Both image streams are PNG,
decoded by the port's own codec (`utils/images.py`), so a TUM sequence
with an undistorted calibration loads on a machine without OpenCV.
"""

from __future__ import annotations

import os

import numpy as np

from ..utils.images import read_image
from .base import BaseDataset


def read_stamped_table(path: str, skiprows: int = 0) -> np.ndarray:
    """A TUM-format text table: whitespace-separated, '#' comments, the
    first column a float timestamp. skiprows counts raw file lines
    (comments included), as np.loadtxt does: on standard TUM files the
    skipped line is the comment header. Ragged rows are padded with "" or
    cut to the most common column count, as the reference's
    genfromtxt(filling_values="") reads them."""
    rows = []
    with open(path) as f:
        for lineno, line in enumerate(f):
            if lineno < skiprows:
                continue
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            rows.append(line.split())
    if not rows:
        return np.asarray(rows, dtype=np.str_)
    ncol = int(np.bincount([len(r) for r in rows]).argmax())
    rows = [r[:ncol] + [""] * (ncol - len(r)) for r in rows]
    return np.asarray(rows, dtype=np.str_)


def _nearest(src_times: np.ndarray, query_times: np.ndarray):
    """For each query timestamp, the index of the nearest src timestamp and
    the absolute gap (searchsorted on the sorted src stream)."""
    order = np.argsort(src_times, kind="stable")
    srt = src_times[order]
    pos = np.searchsorted(srt, query_times)
    below = np.clip(pos - 1, 0, len(srt) - 1)
    above = np.clip(pos, 0, len(srt) - 1)
    take_above = np.abs(srt[above] - query_times) < np.abs(srt[below] - query_times)
    idx = order[np.where(take_above, above, below)]
    return idx, np.abs(src_times[idx] - query_times)


def match_streams(t_rgb, t_depth, t_pose=None, max_dt: float = 0.08):
    """Associate the rgb stream with the depth (and optionally the pose)
    stream by nearest timestamp, keeping only the rgb frames whose match on
    every stream is within max_dt. -> aligned index arrays (rgb_idx,
    depth_idx) or (rgb_idx, depth_idx, pose_idx)."""
    t_rgb = np.asarray(t_rgb, np.float64)
    depth_idx, depth_gap = _nearest(np.asarray(t_depth, np.float64), t_rgb)
    good = depth_gap < max_dt
    if t_pose is None:
        rgb_idx = np.nonzero(good)[0]
        return rgb_idx, depth_idx[rgb_idx]
    pose_idx, pose_gap = _nearest(np.asarray(t_pose, np.float64), t_rgb)
    rgb_idx = np.nonzero(good & (pose_gap < max_dt))[0]
    return rgb_idx, depth_idx[rgb_idx], pose_idx[rgb_idx]


def thin_to_rate(times: np.ndarray, rate_hz: float) -> np.ndarray:
    """Greedy thinning: keep the first sample, then each sample more than
    1/rate_hz after the last one kept (sequential by nature)."""
    min_gap = 1.0 / rate_hz
    kept = [0]
    t_last = times[0]
    for i in range(1, len(times)):
        if times[i] - t_last > min_gap:
            kept.append(i)
            t_last = times[i]
    return np.asarray(kept, np.int64)


def tum_quat_to_c2w(pvec: np.ndarray) -> np.ndarray:
    """tx ty tz qx qy qz qw -> (4, 4) c2w."""
    t = pvec[0:3]
    qx, qy, qz, qw = pvec[3:7]
    n = qw * qw + qx * qx + qy * qy + qz * qz
    s = 0.0 if n == 0 else 2.0 / n
    R = np.array([
        [1 - s * (qy * qy + qz * qz), s * (qx * qy - qz * qw), s * (qx * qz + qy * qw)],
        [s * (qx * qy + qz * qw), 1 - s * (qx * qx + qz * qz), s * (qy * qz - qx * qw)],
        [s * (qx * qz - qy * qw), s * (qy * qz + qx * qw), 1 - s * (qx * qx + qy * qy)],
    ])
    T = np.eye(4)
    T[:3, :3] = R
    T[:3, 3] = t
    return T


class TUMDataset(BaseDataset):
    def __init__(self, config: dict):
        super().__init__(config)
        self.root = os.path.expanduser(config["Dataset"]["dataset_path"])
        self._load_tum(self.root, frame_rate=32)

    def _load_tum(self, datapath: str, frame_rate: int):
        pose_file = os.path.join(datapath, "groundtruth.txt")
        if not os.path.isfile(pose_file):
            pose_file = os.path.join(datapath, "pose.txt")
        rgb_tab = read_stamped_table(os.path.join(datapath, "rgb.txt"))
        depth_tab = read_stamped_table(os.path.join(datapath, "depth.txt"))
        pose_tab = read_stamped_table(pose_file, skiprows=1)
        pose_vecs = pose_tab[:, 1:].astype(np.float64)

        t_rgb = rgb_tab[:, 0].astype(np.float64)
        ri, di, pi = match_streams(t_rgb, depth_tab[:, 0].astype(np.float64),
                                   pose_tab[:, 0].astype(np.float64))
        sel = thin_to_rate(t_rgb[ri], frame_rate)
        ri, di, pi = ri[sel], di[sel], pi[sel]

        self.color_paths = [os.path.join(datapath, p) for p in rgb_tab[ri, 1]]
        self.depth_paths = [os.path.join(datapath, p) for p in depth_tab[di, 1]]
        self.poses_w2c = [np.linalg.inv(tum_quat_to_c2w(pose_vecs[k])) for k in pi]

    def __len__(self):
        return len(self.color_paths)

    def __getitem__(self, idx: int) -> dict:
        rgb = read_image(self.color_paths[idx], "color")
        depth = read_image(self.depth_paths[idx], "unchanged")
        rgb = self.undistort_rgb(rgb)
        rgb = (rgb / 255.0).astype(np.float32)
        depth = depth.astype(np.float32) / self.depth_scale
        return {
            "rgb": rgb,
            "depth": depth,
            "pose": self.poses_w2c[idx].astype(np.float32),
            "mask": np.ones(depth.shape, bool),
            "segmentation": np.zeros(depth.shape, np.int32),
        }
