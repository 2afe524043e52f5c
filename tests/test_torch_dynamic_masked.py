"""monogs_torch's masked moving object through `SLAM.run()` on the CPU (the
port of tests/test_dynamic.py:100): with the moving object masked out of
every loss, the tracking ATE must be as good as on the static scene (under
0.05, and within 0.015 of the static run's). Two whole SLAM runs, so a
file, and a test worker, of its own."""

import copy

import torch

from test_torch_dynamic import _isolated_cache, dyn_cfg, make_slam  # noqa: F401 (autouse)
from test_torch_system import CFG

torch.set_num_threads(2)   # the test workers share the CPUs (tests/test_torch_system.py)


def test_masked_moving_object_does_not_hurt_ate():
    rmse_static = make_slam(copy.deepcopy(CFG)).run()
    rmse_masked = make_slam(dyn_cfg(masked=True)).run()
    assert rmse_masked < 0.05, f"masked-dynamic ATE {rmse_masked}"
    assert rmse_masked < rmse_static + 0.015, (
        f"masked moving object degraded ATE: {rmse_masked:.4f} vs static {rmse_static:.4f}")
