"""Camera models and projective geometry (port of monogs_tpu/ops/graphics.py).

The rasterizer works directly with pinhole intrinsics; the OpenGL-convention
projection matrix is kept for export. Rigid transforms of point sets are
written as elementwise multiply-and-sum over the 3 coordinates (as
ops/lie.py's `_mv`), so TF32 cannot reach them on the card.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch


class Intrinsics(NamedTuple):
    """Pinhole intrinsics as plain Python numbers (width/height fix the
    image shapes; fx/fy are frozen, as in the reference)."""

    fx: float
    fy: float
    cx: float
    cy: float
    width: int
    height: int

    @property
    def fovx(self) -> float:
        return 2.0 * math.atan(self.width / (2.0 * float(self.fx)))

    @property
    def fovy(self) -> float:
        return 2.0 * math.atan(self.height / (2.0 * float(self.fy)))


def world_to_view(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """(R, t) world-to-camera -> (4, 4) homogeneous W2C matrix."""
    T = torch.eye(4, dtype=R.dtype, device=R.device)
    T[:3, :3] = R
    T[:3, 3] = t
    return T


def camera_center(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Camera origin in world coordinates: -R^T t."""
    return -(R * t[:, None]).sum(0)


def get_projection_matrix(znear, zfar, cx, cy, fx, fy, W, H,
                          device=None) -> torch.Tensor:
    """Principal-point-aware OpenGL-convention projection (export only)."""
    left = ((2 * cx - W) / W - 1.0) * W / 2.0
    right = ((2 * cx - W) / W + 1.0) * W / 2.0
    top = ((2 * cy - H) / H + 1.0) * H / 2.0
    bottom = ((2 * cy - H) / H - 1.0) * H / 2.0
    left = znear / fx * left
    right = znear / fx * right
    top = znear / fy * top
    bottom = znear / fy * bottom

    P = torch.zeros((4, 4), dtype=torch.float32, device=device)
    P[0, 0] = 2.0 * znear / (right - left)
    P[1, 1] = 2.0 * znear / (top - bottom)
    P[0, 2] = (right + left) / (right - left)
    P[1, 2] = (top + bottom) / (top - bottom)
    P[3, 2] = 1.0
    P[2, 2] = zfar / (zfar - znear)
    P[2, 3] = -(zfar * znear) / (zfar - znear)
    return P


def unproject(depth: torch.Tensor, intr: Intrinsics) -> torch.Tensor:
    """Backproject an (H, W) depth map to (H, W, 3) camera-space points at
    pixel centres."""
    H, W = depth.shape
    u = torch.arange(W, dtype=depth.dtype, device=depth.device)[None, :] + 0.5
    v = torch.arange(H, dtype=depth.dtype, device=depth.device)[:, None] + 0.5
    x = (u - intr.cx) / intr.fx * depth
    y = (v - intr.cy) / intr.fy * depth
    return torch.stack([x, y, depth], dim=-1)


def transform_points(R: torch.Tensor, t: torch.Tensor,
                     pts: torch.Tensor) -> torch.Tensor:
    """Apply a rigid transform to (..., 3) points: pts @ R^T + t."""
    return (pts[..., None, :] * R).sum(-1) + t


def cam_to_world(R: torch.Tensor, t: torch.Tensor,
                 pts_cam: torch.Tensor) -> torch.Tensor:
    """Inverse rigid transform: camera-space (..., 3) -> world, (p - t) @ R."""
    return ((pts_cam - t)[..., :, None] * R).sum(-2)
