"""monogs_torch's whole synchronous `SLAM.run()` on the CPU, on
tests/test_slam_e2e.py's CFG with that file's budgets and backend (the
dense oracle), run once in a module fixture as that file's `slam_run` is
(tests/test_slam_e2e.py:40). On that one run, the ports of that file's
checks: the e2e bounds (:64-105: ATE < 0.05 and under half the summed
motion, PSNR > 15 over at least two frames, 100 < active < capacity, the
window managed, the PLY round trip), the refinement (:108-113: 20
iterations must not lose more than 1 dB), and the visibility cadence
(:116-156: visibility rendered once after 5 mapping steps prunes as the
per-iteration accounting would). The refinement test puts the SLAM's state
back when it ends, and the cadence test starts from the state the run
left, so no test depends on another's order. The lockstep comparison with
the JAX package on the same CFG is tests/test_torch_system.py.
"""

import numpy as np
import pytest
import torch

from monogs_torch.slam import mapper as tm
from monogs_torch.slam import system as tsys
from test_torch_system import CFG, _configs

torch.set_num_threads(2)   # the test workers share the CPUs (tests/test_torch_system.py)


@pytest.fixture(scope="module")
def slam_run():
    """-> (slam, final ATE, the mapper state the run ended with)."""
    from monogs_torch.data.synthetic import SyntheticDataset

    mp = pytest.MonkeyPatch()
    mp.setenv("MONOGS_SYNTH_CACHE", "0")
    try:
        slam = tsys.SLAM(SyntheticDataset(CFG, device="cpu"), **_configs("torch", "ref"),
                         device="cpu")
        rmse = slam.run()
    finally:
        mp.undo()
    return slam, rmse, slam.state


def test_run_meets_the_e2e_bounds(slam_run, tmp_path):
    from monogs_torch.utils.ply import load_ply

    slam, rmse, _ = slam_run
    motion = sum(np.linalg.norm(slam.gt_poses[i][1] - slam.gt_poses[i - 1][1])
                 for i in range(1, len(slam.gt_poses)))
    assert rmse < 0.5 * float(motion) and rmse < 0.05, (rmse, motion)
    n = int(slam.state.gmap.num_active)
    assert 100 < n < slam.state.gmap.capacity
    res = slam.eval_rendering(every=3)
    assert res["mean_psnr"] > 15.0 and res["n_frames"] >= 2, res
    assert 1 <= len(slam.kf_list) <= 4 + 1
    assert all(i in slam.vis_dict for i in slam.kf_list)
    path = str(tmp_path / "map.ply")
    slam.save_map(path)
    data = load_ply(path)
    assert data["xyz"].shape[0] == n and data["quats"].shape[1] == 4


def test_refinement_improves_or_holds_psnr(slam_run):
    slam, _, state = slam_run
    try:
        before = slam.eval_rendering(every=4)["mean_psnr"]
        slam.refine(iters=20)
        after = slam.eval_rendering(every=4)["mean_psnr"]
        assert int(slam.state.nr_iters) == int(state.nr_iters) + 20
    finally:
        slam.state = state
    assert after > before - 1.0  # must not blow up the map


def test_visibility_cadence_matches_per_iteration(slam_run):
    """The reference refreshes the visibility from n_touched on every
    mapping iteration, so at prune time it holds what the last iteration's
    render saw (before its Adam step); the mapper renders the visibility
    once at the cadence boundary (after the step, `visibility_pass`). Both
    accountings must give nearly the same covisibility-prune masks: they
    sit one Adam step apart, and an n_touched flip under one sub-pixel step
    moves a Gaussian's observation count, so the JAX suite's bounds hold
    (decisions agree on >= 97% of active rows, prune counts within 5% or
    10)."""
    slam, _, st = slam_run
    intr, cfg = slam.intr, slam.mcfg
    vis_ref = None
    for _ in range(5):
        vis_ref = tm.visibility_pass(st, intr, cfg)
        st, _ = tm.mapping_step(st, intr, cfg, init=False)
    vis_ours = tm.visibility_pass(st, intr, cfg)
    floor = -(2 ** 31)                       # every row eligible
    _, mask_ref = tm.covisibility_prune(st, vis_ref, floor, cfg)
    _, mask_ours = tm.covisibility_prune(st, vis_ours, floor, cfg)
    n_ref, n_ours = int(mask_ref.sum()), int(mask_ours.sum())
    n_diff, n_active = int((mask_ref != mask_ours).sum()), int(st.gmap.active.sum())
    assert n_diff <= 0.03 * n_active, (
        f"prune decisions diverge on {n_diff} of {n_active} rows "
        f"(per-iteration would prune {n_ref})")
    assert abs(n_ours - n_ref) <= max(0.05 * n_ref, 10), (n_ours, n_ref)
