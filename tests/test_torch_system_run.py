"""monogs_torch's whole synchronous `SLAM.run()` on the CPU, on
tests/test_slam_e2e.py's CFG with that file's budgets and backend (the
dense oracle): it must meet that file's bounds (tests/test_slam_e2e.py:
64-116): ATE < 0.05 and under half the summed motion, PSNR > 15 over at
least two frames, 100 < active < capacity, the window managed, the PLY
round trip. The lockstep comparison with the JAX package on the same CFG
is tests/test_torch_system.py."""

import numpy as np

from monogs_torch.slam import system as tsys
from test_torch_system import CFG, _configs


def test_run_meets_the_e2e_bounds(tmp_path, monkeypatch):
    from monogs_torch.data.synthetic import SyntheticDataset
    from monogs_torch.utils.ply import load_ply

    monkeypatch.setenv("MONOGS_SYNTH_CACHE", "0")
    slam = tsys.SLAM(SyntheticDataset(CFG, device="cpu"), **_configs("torch", "ref"),
                     device="cpu")
    rmse = slam.run()
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
