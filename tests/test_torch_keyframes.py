"""monogs_torch's keyframe logic against monogs_tpu's on the CPU: the same
poses and visibility masks (numpy, from a seed) must give the same
keyframe decisions, overlap ratios, windows and evictions, exactly. The
cases cover both eviction rules (overlap under the cutoff, before and
after the window first fills; the inverse-distance redundancy when the
window is over capacity) and masks taken before a map grow (shorter,
zero-padded)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from monogs_tpu.slam import keyframes as jkf
from monogs_torch.slam import keyframes as tkf

C = 600


def _pose(rng, scale):
    w = rng.normal(size=3) * 0.1
    th = np.linalg.norm(w)
    K = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]]) / th
    R = np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * K @ K
    return R.astype(np.float32), (rng.normal(size=3) * scale).astype(np.float32)


def _scene(seed, n_kf):
    """n_kf + 1 poses and visibility masks: each frame sees a window of the
    map that drifts with its index, some masks shorter (before a grow)."""
    rng = np.random.default_rng(seed)
    poses, vis = {}, {}
    for i in range(n_kf + 1):
        poses[i] = _pose(rng, 0.05 + 0.3 * rng.uniform())
        lo = int(rng.integers(0, C // 2)) if rng.uniform() < 0.4 else 20 * i
        m = np.zeros(C, bool)
        m[lo:lo + int(rng.integers(80, 300))] = True
        m &= rng.uniform(size=C) < 0.9
        n = C - 100 if rng.uniform() < 0.3 else C
        vis[i] = m[:n]
    return poses, vis


@pytest.mark.parametrize("seed", range(8))
@pytest.mark.parametrize("full", [False, True])
@pytest.mark.parametrize("members", [3, 5])
def test_add_to_window_matches_jax(seed, full, members):
    """members 5: a full window, over capacity once the new keyframe joins."""
    cfg_j = jkf.KeyframeConfig(window_size=5)
    cfg_t = tkf.KeyframeConfig(window_size=5)
    poses, vis = _scene(seed, 6)
    cur = 6
    kf_list = list(range(5, 5 - members, -1))
    kl_j, rm_j = jkf.add_to_window(cur, jnp.asarray(vis[cur]), kf_list,
                                   {k: jnp.asarray(v) for k, v in vis.items()},
                                   poses, cfg_j, full)
    kl_t, rm_t = tkf.add_to_window(cur, torch.as_tensor(vis[cur]), kf_list,
                                   {k: torch.as_tensor(v) for k, v in vis.items()},
                                   poses, cfg_t, full)
    assert (kl_t, rm_t) == (kl_j, rm_j)
    assert len(kl_t) <= cfg_t.window_size


def test_both_eviction_rules_are_covered():
    """Across the full-window cases, some event evicts by overlap (a member
    past the n_dont_touch newest at or under the cutoff) and some by
    distance (no such member)."""
    by_overlap = by_distance = 0
    cfg = tkf.KeyframeConfig(window_size=5)
    for seed in range(8):
        for full in (False, True):
            _, vis = _scene(seed, 6)
            tv = {k: torch.as_tensor(v) for k, v in vis.items()}
            cutoff = cfg.kf_cutoff if full else 0.4
            low = [tkf.overlap_ratio_min(tv[6], tv[k]) <= cutoff for k in (4, 3, 2, 1)]
            by_overlap += any(low)
            by_distance += not any(low)
    assert by_overlap and by_distance


@pytest.mark.parametrize("seed", range(6))
def test_overlaps_and_keyframe_decision_match_jax(seed):
    poses, vis = _scene(seed + 10, 2)
    a, b = vis[1], vis[2]
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    ta, tb = torch.as_tensor(a), torch.as_tensor(b)
    assert tkf.overlap_ratio_union(ta, tb) == jkf.overlap_ratio_union(ja, jb)
    assert tkf.overlap_ratio_min(ta, tb) == jkf.overlap_ratio_min(ja, jb)
    assert tkf._rel_translation(*poses[1], *poses[2]) == \
        jkf._rel_translation(*poses[1], *poses[2])
    for median_depth in (0.2, 1.0, 3.0, 20.0):
        for overlap in (0.05, 0.5, 0.9):
            kw = dict(kf_overlap=overlap)
            dj = jkf.should_add_as_keyframe(poses[1], poses[2], ja, jb, median_depth,
                                            jkf.KeyframeConfig(**kw))
            dt = tkf.should_add_as_keyframe(poses[1], poses[2], ta, tb, median_depth,
                                            tkf.KeyframeConfig(**kw))
            assert dt == dj, (median_depth, overlap)
