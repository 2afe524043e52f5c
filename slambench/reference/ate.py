"""Absolute trajectory error: the RMSE of the camera centres, with no
alignment (an RGB-D run starts at the ground truth's first pose, so its
frame is the ground truth's) or after a least-squares similarity
alignment (Umeyama 1991) of the estimate to the ground truth (a
monocular run, whose scale is its own)."""

from __future__ import annotations

import numpy as np


def centres(poses_w2c) -> np.ndarray:
    """(n, 4, 4) world-to-camera poses -> (n, 3) camera centres."""
    P = np.asarray(poses_w2c, np.float64)
    R, t = P[:, :3, :3], P[:, :3, 3]
    return -np.einsum("nji,nj->ni", R, t)


def umeyama(src: np.ndarray, dst: np.ndarray, with_scale: bool):
    """(s, R, t) minimising |dst - (s R src + t)|^2."""
    mu_s, mu_d = src.mean(0), dst.mean(0)
    xs, xd = src - mu_s, dst - mu_d
    cov = xd.T @ xs / len(src)
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1.0
    R = U @ S @ Vt
    var = (xs * xs).sum() / len(src)
    s = float(np.trace(np.diag(D) @ S) / var) if with_scale and var > 0 else 1.0
    return s, R, mu_d - s * R @ mu_s


def ate_rmse(est_w2c, gt_w2c, align: str) -> float:
    """align: "none" or "sim3"."""
    if align not in ("none", "sim3"):
        raise ValueError(f"align must be none or sim3, got {align!r}")
    est, gt = centres(est_w2c), centres(gt_w2c)
    if align == "sim3" and len(est) >= 3:
        s, R, t = umeyama(est, gt, with_scale=True)
        est = s * est @ R.T + t
    return float(np.sqrt(((est - gt) ** 2).sum(1).mean()))
