"""The port's SLAM on the parsed datasets, on the CPU (the ports of
tests/test_datasets.py's test_slam_runs_on_tum_fixture (:351),
test_slam_step_on_euroc_fixture (:229) and test_slam_on_synthetic_stereo
(:437)): init and one tracked frame on the TUM fixture, on the EuRoC pair's
SGBM depth, and on the stereo synthetic rig's SGBM depth, at the JAX
tests' budgets and sizes. The TUM run goes through the `slab` backend (the
kernels' plain twins on the CPU); the EuRoC and stereo runs through the
dense oracle ("ref"), as their JAX tests do (the twins take seconds an
iteration at their widths on the CPU). Each needs a map of more than 10
active Gaussians and a pose for frame 1. A SLAM run has this file's worker
to itself.
"""

import numpy as np
import pytest
import torch

from monogs_torch.data import load_dataset
from monogs_torch.slam.keyframes import KeyframeConfig
from monogs_torch.slam.mapper import MapperConfig
from monogs_torch.slam.system import SLAM
from monogs_torch.slam.tracker import TrackerConfig
from monogs_torch.utils.config import SystemConfig
from test_torch_datasets import (
    _euroc_config,
    _synth_stereo_config,
    _tum_config,
    _write_euroc_fixture,
    _write_tum_fixture,
)

pytest.importorskip("cv2")
torch.set_num_threads(2)   # the test workers share the CPUs (tests/test_torch_system.py)


def _two_frames(ds, backend: str, iters: int, init: int, kf_iters: int, cap: int,
                map_cap: int, headroom: int) -> SLAM:
    slam = SLAM(
        ds,
        tracker_config=TrackerConfig(tile_size=16, max_iters=iters, tile_capacity=cap,
                                     max_dup=16, backend=backend, opacity_threshold=0.5),
        mapper_config=MapperConfig(tile_size=16, init_itr_num=init, iters_per_kf=kf_iters,
                                   gaussian_update_every=1000, prune_coviz=1,
                                   tile_capacity=cap, max_dup=16, backend=backend),
        keyframe_config=KeyframeConfig(window_size=3),
        system_config=SystemConfig(map_capacity=map_cap, capacity_headroom=headroom,
                                   eval_every=0),
        device="cpu")
    slam.process_frame(0)
    slam.process_frame(1)
    return slam


def test_slam_runs_on_tum_fixture(tmp_path):
    root = str(tmp_path / "tum")
    _write_tum_fixture(root)
    slam = _two_frames(load_dataset(_tum_config(root), device="cpu"), "slab", iters=5, init=10,
                       kf_iters=4, cap=128, map_cap=4096, headroom=256)
    assert int(slam.state.gmap.num_active) > 10
    assert 1 in slam.est_poses


def test_slam_step_on_euroc_fixture(tmp_path):
    root = str(tmp_path / "euroc")
    _write_euroc_fixture(root)
    slam = _two_frames(load_dataset(_euroc_config(root), device="cpu"), "ref", iters=4, init=8,
                       kf_iters=3, cap=128, map_cap=4096, headroom=256)
    assert int(slam.state.gmap.num_active) > 10
    assert 1 in slam.est_poses


def test_slam_on_synthetic_stereo(tmp_path, monkeypatch):
    monkeypatch.setenv("MONOGS_SYNTH_CACHE_DIR", str(tmp_path / "cache"))
    ds = load_dataset(_synth_stereo_config(), device="cpu")
    assert (np.asarray(ds[0]["depth"]) > 0).mean() > 0.25
    slam = _two_frames(ds, "ref", iters=6, init=10, kf_iters=4, cap=256, map_cap=8192,
                       headroom=512)
    assert int(slam.state.gmap.num_active) > 10
    assert 1 in slam.est_poses
