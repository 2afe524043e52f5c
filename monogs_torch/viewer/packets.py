"""Viewer packets: the snapshots the SLAM loop pushes to the web viewer
(port of monogs_tpu/viewer/packets.py).

A packet holds references, not copies: the map's functions build new
tensors and never write one that a packet holds (`_scatter_rows` writes
into a fresh `torch.cat`, `adam_step` and the events return new tensors),
so a snapshot stays as it was pushed. On a card the tensors may still be
being written when the packet is pushed: `ready` is a CUDA event recorded
on the pushing thread's stream after that, which a reader on another
stream waits for (None on the CPU).
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Any


@dataclasses.dataclass
class MainToViewerPacket:
    """The latest state (the reference's viewer_packet.py:10-59)."""

    params: dict | None = None          # GaussianMap params (raw, not activated)
    active: Any = None
    kf_idx: Any = None                  # (C,) creating keyframe per Gaussian
    obj_prob: Any = None
    intrinsics: Any = None
    cur_frame_idx: int = 0
    cur_pose: tuple | None = None       # numpy (R, t) of the current frame
    gt_pose: tuple | None = None
    kf_poses: dict | None = None        # idx -> numpy (R, t) of the window keyframes
    gt_rgb: Any = None                  # the current input frame (H, W, 3)
    gt_depth: Any = None
    gt_segmentation: Any = None
    ready: Any = None                   # CUDA event after the tensors' writes
    finish: bool = False


@dataclasses.dataclass
class ViewerToMainPacket:
    """The user's controls (the reference's gui_utils.py:114-117)."""

    paused: bool = False


class LatestSlot:
    """A one-slot queue that keeps only the newest packet (the reference's
    get_latest_queue, gui_utils.py:100-111, without a backlog)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._value = None

    def put(self, value):
        with self._lock:
            self._value = value

    def get(self):
        with self._lock:
            return self._value
