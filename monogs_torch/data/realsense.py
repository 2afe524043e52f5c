"""Live Intel RealSense stream (port of monogs_tpu/data/realsense.py): rgb
and aligned depth through pyrealsense2, intrinsics read from the device.
pyrealsense2 is imported when the dataset is built, so the module loads
where the SDK is missing; building one there raises ImportError. The
camera's BGR frames become RGB by a channel flip, the same bytes
OpenCV's cvtColor gives, so this path needs no OpenCV."""

from __future__ import annotations

import numpy as np

from .base import BaseDataset


class RealsenseDataset(BaseDataset):
    def __init__(self, config: dict):
        try:
            import pyrealsense2 as rs
        except ImportError as e:
            raise ImportError("the realsense dataset streams from a live camera through "
                              "pyrealsense2, which is not installed") from e
        self.rs = rs
        self.pipeline = rs.pipeline()
        self.rs_config = rs.config()
        self.use_depth = bool(config["Dataset"].get("use_depth", True))
        self.rs_config.enable_stream(rs.stream.color, format=rs.format.bgr8)
        if self.use_depth:
            self.rs_config.enable_stream(rs.stream.depth)
        self.profile = self.pipeline.start(self.rs_config)
        self.align = rs.align(rs.stream.color) if self.use_depth else None

        rgb_profile = self.profile.get_stream(rs.stream.color)
        intr = rgb_profile.as_video_stream_profile().get_intrinsics()
        calib = config["Dataset"].setdefault("Calibration", {})
        calib.update({"width": intr.width, "height": intr.height, "fx": intr.fx,
                      "fy": intr.fy, "cx": intr.ppx, "cy": intr.ppy, "depth_scale": 1.0})
        if self.use_depth:
            sensor = self.profile.get_device().first_depth_sensor()
            self.rs_depth_scale = sensor.get_depth_scale()
        super().__init__(config)
        self.n_frames = int(config["Dataset"].get("n_frames", 1 << 30))

    def __len__(self):
        return self.n_frames

    def __getitem__(self, idx: int) -> dict:
        frameset = self.pipeline.wait_for_frames()
        if self.align is not None:
            frameset = self.align.process(frameset)
        color = np.asanyarray(frameset.get_color_frame().get_data())
        rgb = (color[..., ::-1] / 255.0).astype(np.float32)
        depth = None
        if self.use_depth:
            depth = (np.asanyarray(frameset.get_depth_frame().get_data()).astype(np.float32)
                     * self.rs_depth_scale)
        H, W = rgb.shape[:2]
        return {
            "rgb": rgb,
            "depth": depth,
            "pose": np.eye(4, dtype=np.float32),  # live: no ground truth
            "mask": np.ones((H, W), bool),
            "segmentation": np.zeros((H, W), np.int32),
        }
