"""Trajectory and rendering evaluation (port of monogs_tpu/utils/eval.py).

ATE: closed-form Umeyama alignment (optional) and the translation RMSE of
the camera centres, in float64 numpy, with the trajectory and stats JSON
artifacts under <save_dir>/plot/. Rendering: PSNR over the ground truth's
nonzero elements and SSIM of the full frames (the port's `ops/losses.ssim`,
on the render's device), written to <save_dir>/psnr/<label>/
final_result.json. LPIPS needs torchmetrics, which neither the CPU rig nor
the card machine has: `mean_lpips` is None, as the JAX package reports
without it.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch


def pose_w2c_to_c2w(R, t):
    R = np.asarray(R, np.float64)
    t = np.asarray(t, np.float64)
    T = np.eye(4)
    T[:3, :3] = R.T
    T[:3, 3] = -R.T @ t
    return T


def umeyama_alignment(src: np.ndarray, dst: np.ndarray, with_scale: bool = False):
    """Least-squares similarity transform aligning src -> dst, both (N, 3):
    (s, R, t) with dst ~ s R src + t (Umeyama 1991)."""
    mu_s = src.mean(axis=0)
    mu_d = dst.mean(axis=0)
    xs = src - mu_s
    xd = dst - mu_d
    cov = xd.T @ xs / src.shape[0]
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    if with_scale:
        var_s = (xs ** 2).sum() / src.shape[0]
        s = float(np.trace(np.diag(D) @ S) / var_s)
    else:
        s = 1.0
    t = mu_d - s * R @ mu_s
    return s, R, t


def ate_rmse(est_c2w: list, gt_c2w: list, align: bool = False,
             align_scale: bool = False) -> float:
    """Translation RMSE between trajectories of (4, 4) c2w matrices, after
    an Umeyama alignment when `align` (with scale when `align_scale`)."""
    est = np.stack([T[:3, 3] for T in est_c2w])
    gt = np.stack([T[:3, 3] for T in gt_c2w])
    if align and est.shape[0] >= 3:
        s, R, t = umeyama_alignment(est, gt, with_scale=align_scale)
        est = (s * (R @ est.T)).T + t
    err = np.linalg.norm(est - gt, axis=1)
    return float(np.sqrt(np.mean(err ** 2)))


def eval_traj_ate(est_poses: dict, gt_poses: dict, save_dir: str | None = None,
                  label: str = "final", kf_indices: list | None = None,
                  align: bool = False, align_scale: bool = False) -> float:
    """ATE over all frames (or the given keyframes) of {idx: (R, t) w2c}
    dicts, writing plot/trj_<label>.json and plot/stats_<label>.json."""
    idxs = sorted(est_poses.keys()) if kf_indices is None else sorted(kf_indices)
    est = [pose_w2c_to_c2w(*est_poses[i]) for i in idxs]
    gt = [pose_w2c_to_c2w(*gt_poses[i]) for i in idxs]
    rmse = ate_rmse(est, gt, align=align, align_scale=align_scale)

    if save_dir is not None:
        plot_dir = os.path.join(save_dir, "plot")
        os.makedirs(plot_dir, exist_ok=True)
        with open(os.path.join(plot_dir, f"trj_{label}.json"), "w") as f:
            json.dump({"trj_id": idxs, "trj_est": [T.tolist() for T in est],
                       "trj_gt": [T.tolist() for T in gt]}, f)
        with open(os.path.join(plot_dir, f"stats_{label}.json"), "w") as f:
            json.dump({"rmse": rmse, "aligned": align, "n_frames": len(idxs)}, f)
        _plot_trajectory(est, gt, rmse, os.path.join(plot_dir, f"trj_{label}.png"))
    return rmse


def _plot_trajectory(est_c2w, gt_c2w, rmse, path):
    """Top-down trajectory plot; skipped where matplotlib is not installed."""
    try:
        import matplotlib
    except ImportError:
        return
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    est = np.stack([T[:3, 3] for T in est_c2w])
    gt = np.stack([T[:3, 3] for T in gt_c2w])
    fig, ax = plt.subplots(figsize=(6, 6))
    ax.plot(gt[:, 0], gt[:, 2], "k--", label="ground truth")
    ax.plot(est[:, 0], est[:, 2], "c-", label="estimate")
    ax.scatter(est[0, 0], est[0, 2], c="g", marker="^", label="start")
    ax.set_xlabel("x [m]")
    ax.set_ylabel("z [m]")
    ax.set_title(f"ATE RMSE {rmse:.4f} m")
    ax.legend()
    ax.set_aspect("equal", adjustable="datalim")
    fig.tight_layout()
    fig.savefig(path, dpi=90)
    plt.close(fig)


def eval_rendering(render_fn, gt_fn, frame_indices, save_dir: str | None = None,
                   label: str = "final", extra: dict | None = None) -> dict:
    """PSNR and SSIM over the given frames. render_fn(idx) -> (H, W, 3)
    rendered rgb tensor at the estimated pose; gt_fn(idx) -> ((H, W, 3) rgb,
    (H, W) depth or None) as numpy. PSNR is over the gt > 0 elements only
    (per channel), SSIM over the full frames on the render's device."""
    from ..ops.losses import ssim as ssim_fn

    psnrs, ssims = [], []
    for idx in frame_indices:
        out_t = render_fn(idx)
        gt_rgb = np.asarray(gt_fn(idx)[0])
        out = out_t.detach().cpu().numpy()
        mask = gt_rgb > 0
        if mask.any():
            mse = float(((out - gt_rgb)[mask] ** 2).mean())
            psnrs.append(20.0 * np.log10(1.0 / np.sqrt(max(mse, 1e-12))))
        else:
            psnrs.append(0.0)
        gt_t = torch.as_tensor(gt_rgb, dtype=torch.float32, device=out_t.device)
        ssims.append(float(ssim_fn(out_t, gt_t)))

    result = {
        "mean_psnr": float(np.mean(psnrs)) if psnrs else 0.0,
        "mean_ssim": float(np.mean(ssims)) if ssims else 0.0,
        "mean_lpips": None,
        "n_frames": len(psnrs),
    }
    if extra:
        result.update(extra)
    if save_dir is not None:
        out_dir = os.path.join(save_dir, "psnr", label)
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, "final_result.json"), "w") as f:
            json.dump(result, f)
    return result
