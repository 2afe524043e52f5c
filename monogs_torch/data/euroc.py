"""EuRoC MAV stereo parser (port of monogs_tpu/data/euroc.py).

cam0 / cam1 PNG streams, decoded to gray by the port's own codec; poses
from the state-groundtruth CSV (the body pose times the body-to-cam0
extrinsic T_I_C0); the config's rectification (raw K and distortion to
the opt K through each camera's R) and SGBM disparity through OpenCV, as in
the JAX package, with depth = baseline * fx / disparity (BF, the ORB-SLAM2
value). Without OpenCV the constructor raises ImportError.
"""

from __future__ import annotations

import csv
import glob
import os

import numpy as np

from ..utils.images import read_image
from .base import BaseDataset, cv2_for, quat_wxyz_to_rotmat

# Body-to-cam0 extrinsic (the EuRoC calibration).
T_I_C0 = np.array([
    [0.0148655429818, -0.999880929698, 0.00414029679422, -0.0216401454975],
    [0.999557249008, 0.0149672133247, 0.025715529948, -0.064676986768],
    [-0.0257744366974, 0.00375618835797, 0.999660727178, 0.00981073058949],
    [0.0, 0.0, 0.0, 1.0],
])
BF = 47.90639384423901  # baseline * fx
_WHY_CV2 = "rectifying EuRoC's stereo pairs and their SGBM depth"


def _K(c):
    return np.array([[c["fx"], 0.0, c["cx"]], [0.0, c["fy"], c["cy"]], [0.0, 0.0, 1.0]])


def _dist(c):
    return np.array([c["k1"], c["k2"], c["p1"], c["p2"], c["k3"]])


class EurocDataset(BaseDataset):
    def __init__(self, config: dict):
        calib = config["Dataset"]["Calibration"]
        cam0opt = calib["cam0"]["opt"]
        # BaseDataset takes the rectified (opt) pinhole model.
        flat = dict(calib)
        flat.update(cam0opt)
        flat["distorted"] = False  # rectified here, not in the base
        config = dict(config)
        config["Dataset"] = dict(config["Dataset"])
        config["Dataset"]["Calibration"] = flat
        super().__init__(config)
        self.has_depth = True  # depth from stereo SGBM

        self.root = os.path.expanduser(config["Dataset"]["dataset_path"])
        start_idx = int(config["Dataset"].get("start_idx", 0))
        self.color_paths = sorted(glob.glob(f"{self.root}/mav0/cam0/data/*.png"))[start_idx:]
        self.color_paths_r = sorted(glob.glob(f"{self.root}/mav0/cam1/data/*.png"))[start_idx:]
        self._load_poses(f"{self.root}/mav0/state_groundtruth_estimate0/data.csv")

        # Rectification maps, raw -> opt.
        cv2 = cv2_for(_WHY_CV2)
        cam0raw, cam1raw = calib["cam0"]["raw"], calib["cam1"]["raw"]
        cam1opt = calib["cam1"]["opt"]
        R0 = np.array(calib["cam0"]["R"]["data"]).reshape(3, 3)
        R1 = np.array(calib["cam1"]["R"]["data"]).reshape(3, 3)
        size = (self.width, self.height)
        self.map_l = cv2.initUndistortRectifyMap(
            _K(cam0raw), _dist(cam0raw), R0, _K(cam0opt), size, cv2.CV_32FC1)
        self.map_r = cv2.initUndistortRectifyMap(
            _K(cam1raw), _dist(cam1raw), R1, _K(cam1opt), size, cv2.CV_32FC1)

    def _load_poses(self, path):
        with open(path) as f:
            reader = csv.reader(f)
            next(reader)
            data = np.array([list(map(float, row)) for row in reader])
        pose_ts = data[:, 0]
        self.poses_w2c = []
        for p in self.color_paths:
            color_ts = float(p.split("/")[-1].split(".")[0])
            k = int(np.argmin(np.abs(pose_ts - color_ts)))
            T_w_i = np.eye(4)
            T_w_i[:3, :3] = quat_wxyz_to_rotmat(data[k, 4:8])
            T_w_i[:3, 3] = data[k, 1:4]
            self.poses_w2c.append(np.linalg.inv(T_w_i @ T_I_C0))

    def __len__(self):
        return len(self.color_paths)

    def __getitem__(self, idx: int) -> dict:
        cv2 = cv2_for(_WHY_CV2)
        img_l = cv2.remap(read_image(self.color_paths[idx], "gray"), *self.map_l,
                          cv2.INTER_LINEAR)
        img_r = cv2.remap(read_image(self.color_paths_r[idx], "gray"), *self.map_r,
                          cv2.INTER_LINEAR)

        # SGBM disparity -> depth.
        sgbm = cv2.StereoSGBM_create(minDisparity=0, numDisparities=64, blockSize=20)
        sgbm.setUniquenessRatio(40)
        disp = sgbm.compute(img_l, img_r).astype(np.float32) / 16.0
        disp[disp == 0] = 1e10
        depth = BF / disp
        depth[depth < 0] = 0

        rgb = (np.repeat(img_l[..., None], 3, axis=2) / 255.0).astype(np.float32)
        return {
            "rgb": rgb,
            "depth": depth.astype(np.float32),
            "pose": self.poses_w2c[idx].astype(np.float32),
            "mask": np.ones(depth.shape, bool),
            "segmentation": np.zeros(depth.shape, np.int32),
        }
