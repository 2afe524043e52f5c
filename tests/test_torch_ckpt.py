"""monogs_torch's checkpoints (utils/ckpt.py) on the CPU: the ports of
tests/test_ckpt.py (the round trip, after which a restored SLAM continues
as the uninterrupted one does: its random generator restored, the next
frame's pose within 1e-5; and the cold resume of an async run from a
checkpoint its tracker thread wrote), and the atomic write: a save that
dies leaves the previous checkpoint loadable."""

import copy
import os

import numpy as np
import pytest
import torch

from monogs_torch.data.synthetic import SyntheticDataset
from monogs_torch.slam.keyframes import KeyframeConfig
from monogs_torch.slam.mapper import MapperConfig
from monogs_torch.slam.system import SLAM
from monogs_torch.slam.tracker import TrackerConfig
from monogs_torch.utils import ckpt
from monogs_torch.utils.ckpt import load_checkpoint, save_checkpoint, state_tensors
from monogs_torch.utils.config import SystemConfig
from test_torch_system import _no_frame_cache  # noqa: F401 (autouse: cache off)

torch.set_num_threads(2)   # the test workers share the CPUs (tests/test_torch_system.py)

# tests/test_ckpt.py's CFG.
CFG = {
    "Dataset": {
        "type": "synthetic",
        "Calibration": {"width": 64, "height": 48, "fx": 50.0, "fy": 50.0,
                        "cx": 32.0, "cy": 24.0, "depth_scale": 1.0},
        "Objects": {"static": [0], "dynamic": [], "masked": []},
        "synthetic": {"n_frames": 3, "n_gaussians": 400, "seed": 1,
                      "motion_scale": 0.008},
    },
}


def _make_slam(cfg=CFG, save_dir=None, ckpt_every=0, **map_kw):
    slam = SLAM(SyntheticDataset(cfg, device="cpu"),
                tracker_config=TrackerConfig(tile_size=16, max_iters=10, tile_capacity=128,
                                             max_dup=16, backend="ref",
                                             opacity_threshold=0.5),
                mapper_config=MapperConfig(tile_size=16, init_itr_num=20,
                                           init_gaussian_update=10, init_gaussian_reset=100,
                                           iters_per_kf=5, tile_capacity=128, max_dup=16,
                                           backend="ref", **map_kw),
                keyframe_config=KeyframeConfig(window_size=3),
                system_config=SystemConfig(map_capacity=4096, capacity_headroom=256,
                                           save_dir=save_dir, ckpt_every=ckpt_every),
                device="cpu")
    return slam


def _same_state(a, b, b_rng=None):
    """a equals b, and a's generator state b's (or b_rng: the generator is
    one object that the mapper's events advance in place)."""
    ta, tb = state_tensors(a), state_tensors(b)
    assert ta.keys() == tb.keys()
    for k in ta:
        assert torch.equal(ta[k], tb[k]), k
    assert torch.equal(a.rng.get_state(), b.rng.get_state() if b_rng is None else b_rng)


def test_checkpoint_roundtrip(tmp_path):
    slam = _make_slam()
    slam.process_frame(0)
    slam.process_frame(1)
    save_checkpoint(str(tmp_path / "ckpt"), slam)

    slam2 = _make_slam()
    slam2.process_frame(0)             # a different state to restore over
    load_checkpoint(str(tmp_path / "ckpt"), slam2)
    assert slam2.kf_list == slam.kf_list and slam2.kf_history == slam.kf_history
    assert int(slam2.state.gmap.num_active) == int(slam.state.gmap.num_active)
    _same_state(slam2.state, slam.state)
    assert set(slam2.est_poses) == set(slam.est_poses)
    assert slam2.exposures.keys() == slam.exposures.keys()
    assert slam2._window_slots == slam._window_slots == slam.kf_list
    assert (slam2.tcfg, slam2.mcfg) == (slam.tcfg, slam.mcfg)

    # The restored SLAM continues as the uninterrupted one: frame 2 is a
    # keyframe (kf_interval 1), so its extend event draws from the restored
    # generator.
    slam.process_frame(2)
    slam2.process_frame(2)
    np.testing.assert_allclose(slam2.est_poses[2][1], slam.est_poses[2][1], atol=1e-5)
    assert 2 in slam.kf_history
    assert int(slam2.state.gmap.num_active) == int(slam.state.gmap.num_active)


def test_async_checkpoint_cold_resume(tmp_path):
    """An async run checkpoints on its tracker thread every second
    keyframe; a fresh SLAM (state None: the template rebuilt from
    host.json and the dataset's frame 0) restores it and continues the
    remaining frames async; the stitched trajectory covers every frame and
    meets tests/test_ckpt.py's bounds."""
    cfg = copy.deepcopy(CFG)
    cfg["Dataset"]["synthetic"]["n_frames"] = 6
    slam = _make_slam(cfg, save_dir=str(tmp_path / "run"), ckpt_every=2, prune_coviz=1)
    slam.run_async(n_frames=4)
    ckpt_dir = str(tmp_path / "run" / "ckpt")
    assert os.path.isdir(ckpt_dir), "async run never checkpointed"

    slam2 = _make_slam(cfg, prune_coviz=1)
    assert slam2.state is None
    load_checkpoint(ckpt_dir, slam2)
    resume_at = max(slam2.est_poses) + 1
    assert 1 <= resume_at <= 4
    rmse = slam2.run_async(n_frames=6, start_frame=resume_at)
    assert set(slam2.est_poses) == set(range(6))
    assert rmse < 0.05, f"resumed-run ATE {rmse}"
    assert int(slam2.state.gmap.num_active) > 100


def test_interrupted_save_leaves_the_previous_checkpoint(tmp_path, monkeypatch):
    slam = _make_slam()
    slam.process_frame(0)
    path = str(tmp_path / "ckpt")
    save_checkpoint(path, slam)
    first, first_rng = slam.state, slam.state.rng.get_state()
    slam.process_frame(1)

    def die(obj, f, *a, **k):
        with open(f, "wb") as out:
            out.write(b"partial")
        raise OSError("injected: the process died while writing")

    monkeypatch.setattr(ckpt.torch, "save", die)
    with pytest.raises(OSError, match="injected"):
        save_checkpoint(path, slam)
    monkeypatch.undo()
    restored = _make_slam()
    load_checkpoint(path, restored)
    _same_state(restored.state, first, first_rng)
    assert restored.kf_list == [0]

    # A save that died between its two renames: only <path>.old is left.
    save_checkpoint(path, slam)
    os.rename(path, path + ".old")
    restored = _make_slam()
    load_checkpoint(path, restored)
    _same_state(restored.state, slam.state)
    assert restored.kf_list == slam.kf_list
