"""monogs_torch's `run_async` over 110 frames on the CPU (the port of
tests/test_async.py::test_async_stress_bounded_memory): with window churn,
the tracker thread collects its frame cache every frame, so `frames` and
`vis_dict` stay bounded by the window, and the ownership protocol holds
over many evictions. A file of its own: one SLAM run (the tier-1 budget,
ROADMAP Open items)."""

import numpy as np
import torch

from monogs_torch.data.synthetic import SyntheticDataset
from monogs_torch.slam.keyframes import KeyframeConfig
from monogs_torch.slam.mapper import MapperConfig
from monogs_torch.slam.system import SLAM
from monogs_torch.slam.tracker import TrackerConfig
from monogs_torch.utils.config import SystemConfig
from test_torch_async import CFG, _no_mapper_thread
from test_torch_system import _no_frame_cache  # noqa: F401 (autouse: cache off)

torch.set_num_threads(2)   # the test workers share the CPUs (tests/test_torch_system.py)


def test_async_stress_bounded_memory():
    cfg = dict(CFG)
    cfg["Dataset"] = dict(CFG["Dataset"])
    cfg["Dataset"]["synthetic"] = {"n_frames": 110, "n_gaussians": 200, "seed": 7,
                                   "motion_scale": 0.004}
    slam = SLAM(SyntheticDataset(cfg, device="cpu"),
                tracker_config=TrackerConfig(tile_size=16, max_iters=3, tile_capacity=128,
                                             max_dup=16, backend="ref",
                                             opacity_threshold=0.5),
                mapper_config=MapperConfig(tile_size=16, init_itr_num=8,
                                           init_gaussian_update=1000,
                                           init_gaussian_reset=1000, iters_per_kf=2,
                                           gaussian_update_every=1000, prune_coviz=1,
                                           tile_capacity=128, max_dup=16, backend="ref"),
                keyframe_config=KeyframeConfig(window_size=3, kf_interval=2),
                system_config=SystemConfig(map_capacity=4096, capacity_headroom=64),
                device="cpu")
    rmse = slam.run_async()
    assert np.isfinite(rmse)
    assert len(slam.est_poses) == 110
    # Window keyframes + the current frame + write-backs awaiting the next
    # collection (tests/test_async.py's bound).
    assert len(slam.frames) <= slam.kcfg.window_size + 4, len(slam.frames)
    assert len(slam.vis_dict) <= slam.kcfg.window_size + 4, len(slam.vis_dict)
    assert len(slam.kf_history) == 55 and _no_mapper_thread()
