"""Keyframe selection and covisibility window management (port of
monogs_tpu/slam/keyframes.py).

The decisions run on the host between device steps on scalars and on
reductions of the (C,) bool visibility masks; `add_to_window` reads all
the overlap counts it needs in one host read.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..utils.profiling import host_read


@dataclasses.dataclass(frozen=True)
class KeyframeConfig:
    kf_translation: float = 0.08
    kf_min_translation: float = 0.05
    kf_overlap: float = 0.9
    kf_cutoff: float = 0.3
    window_size: int = 8
    n_dont_touch: int = 2
    kf_interval: int = 1
    check_viewpoints_overlap: bool = False


def _rel_translation(R_a, t_a, R_b, t_b) -> float:
    """||(T_a inv(T_b))[:3, 3]|| for w2c poses given as numpy (R, t)."""
    Rrel = np.asarray(R_a) @ np.asarray(R_b).T
    trel = np.asarray(t_a) - Rrel @ np.asarray(t_b)
    return float(np.linalg.norm(trel))


def _pad_to(vis: torch.Tensor, n: int) -> torch.Tensor:
    """Zero-pad a visibility mask to capacity n. Map growth appends slots
    and keeps indices, so a mask taken before a grow is the grown mask
    with trailing False."""
    return vis if vis.shape[0] == n else torch.cat([vis, vis.new_zeros(n - vis.shape[0])])


def _overlap_stats(cur: torch.Tensor, stack: torch.Tensor) -> np.ndarray:
    """[intersections (n,), member counts (n,), |cur| (1,)] of cur (C,)
    against each row of stack (n, C), in one host read."""
    stats = torch.cat([(stack & cur[None, :]).sum(1), stack.sum(1), cur.sum()[None]])
    with host_read():
        return stats.cpu().numpy()


def overlap_ratio_union(vis_a, vis_b) -> float:
    """Intersection over union of two visibility masks."""
    n = max(vis_a.shape[0], vis_b.shape[0])
    inter, counts, ca = _overlap_stats(_pad_to(vis_a, n), _pad_to(vis_b, n)[None])
    return int(inter) / max(int(counts) + int(ca) - int(inter), 1)


def overlap_ratio_min(vis_a, vis_b) -> float:
    """Szymkiewicz-Simpson coefficient: intersection over the smaller mask."""
    n = max(vis_a.shape[0], vis_b.shape[0])
    inter, counts, ca = _overlap_stats(_pad_to(vis_a, n), _pad_to(vis_b, n)[None])
    return int(inter) / max(min(int(ca), int(counts)), 1)


def should_add_as_keyframe(cur_pose, last_kf_pose, cur_vis, last_kf_vis,
                           median_depth: float, cfg: KeyframeConfig) -> bool:
    """cur_pose / last_kf_pose: numpy (R, t) w2c."""
    dist = _rel_translation(*cur_pose, *last_kf_pose)
    dist_check = dist > cfg.kf_translation * median_depth
    dist_check2 = dist > cfg.kf_min_translation * median_depth
    ratio = overlap_ratio_union(cur_vis, last_kf_vis)
    return (ratio < cfg.kf_overlap and dist_check2) or dist_check


def add_to_window(cur_frame_idx: int, cur_vis, kf_list: list, vis_dict: dict,
                  poses: dict, cfg: KeyframeConfig, is_window_full: bool):
    """Prepend the new keyframe; evict the last of the keyframes past the
    n_dont_touch newest whose overlap with it (Szymkiewicz-Simpson) is at
    most the cutoff or, if the window is still over capacity, the keyframe
    of largest inverse-distance redundancy. poses: idx -> numpy (R, t).
    -> (new kf_list, removed idx or None)."""
    N = cfg.n_dont_touch
    kf_list = [cur_frame_idx] + list(kf_list)
    removed = None

    tail = kf_list[N:]
    ratios = {}
    if tail:
        n = max([cur_vis.shape[0]] + [vis_dict[k].shape[0] for k in tail])
        stack = torch.stack([_pad_to(vis_dict[k], n) for k in tail])
        stats = _overlap_stats(_pad_to(cur_vis, n), stack)
        m = len(tail)
        inter, counts, ccur = stats[:m], stats[m:2 * m], int(stats[2 * m])
        ratios = {k: float(inter[i]) / max(min(int(counts[i]), ccur), 1)
                  for i, k in enumerate(tail)}

    cutoff = cfg.kf_cutoff if is_window_full else 0.4
    to_remove = [k for k in tail if ratios[k] <= cutoff]
    if to_remove:
        removed = to_remove[-1]
        kf_list.remove(removed)

    if len(kf_list) > cfg.window_size:
        R0, t0 = poses[cur_frame_idx]
        inv_dist = []
        for i in range(N, len(kf_list)):
            Ri, ti = poses[kf_list[i]]
            inv_dists = []
            for j in range(N, len(kf_list)):
                if i == j:
                    continue
                Rj, tj = poses[kf_list[j]]
                inv_dists.append(1.0 / (_rel_translation(Ri, ti, Rj, tj) + 1e-6))
            k = float(np.sqrt(_rel_translation(Ri, ti, R0, t0)))
            inv_dist.append(k * sum(inv_dists))
        idx = int(np.argmax(inv_dist))
        removed = kf_list[N + idx]
        kf_list.remove(removed)

    return kf_list, removed
