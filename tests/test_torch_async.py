"""monogs_torch's concurrent tracker / mapper mode (`SLAM.run_async`) on the
CPU: the ports of tests/test_async.py's first three tests at that file's
bounds (async tracking beats a static camera, the bootstrap window applies
every result, a mapper fault propagates), and the port's own checks of the
mode:

- bootstrap equivalence: with `async_bootstrap_kfs` at least the number of
  keyframes the tracker waits for every mapper result before it goes on,
  so the operations are `run()`'s, and the trajectory and map must be
  `run()`'s (poses within 1e-6, the same active count). With
  tests/test_torch_system.py, which holds the port's `run()` against
  monogs_tpu's, this holds the port's async path against the JAX package
  by a chain: port async (bootstrap) = port sync = JAX sync;
- a tracker-side exception stops and joins the mapper thread and restores
  the overflow read policy;
- the mapper's per-span overflow read in the concurrent mode, against the
  one deferred read of the synchronous mode.
"""

import dataclasses
import threading

import numpy as np
import pytest
import torch

from monogs_torch.data.synthetic import SyntheticDataset
from monogs_torch.slam import mapper as tm
from monogs_torch.slam.keyframes import KeyframeConfig
from monogs_torch.slam.mapper import MapperConfig
from monogs_torch.slam.system import SLAM
from monogs_torch.slam.tracker import TrackerConfig
from monogs_torch.utils.config import SystemConfig
from test_torch_system import _no_frame_cache  # noqa: F401 (autouse: cache off)

torch.set_num_threads(2)   # the test workers share the CPUs (tests/test_torch_system.py)

# tests/test_async.py's CFG.
CFG = {
    "Dataset": {
        "type": "synthetic",
        "Calibration": {"width": 64, "height": 48, "fx": 50.0, "fy": 50.0,
                        "cx": 32.0, "cy": 24.0, "depth_scale": 1.0},
        "Objects": {"static": [0], "dynamic": [], "masked": []},
        "synthetic": {"n_frames": 6, "n_gaussians": 500, "seed": 5,
                      "motion_scale": 0.008},
    },
}


def _slam(backend="ref", bootstrap=0, **map_kw):
    mapper = dict(tile_size=16, init_itr_num=40, init_gaussian_update=20,
                  init_gaussian_reset=100, iters_per_kf=8, gaussian_update_every=1000,
                  prune_coviz=1, tile_capacity=128, max_dup=16)
    mapper.update(map_kw)
    return SLAM(SyntheticDataset(CFG, device="cpu"),
                tracker_config=TrackerConfig(tile_size=16, max_iters=15, tile_capacity=128,
                                             max_dup=16, backend=backend,
                                             opacity_threshold=0.5),
                mapper_config=MapperConfig(backend=backend, **mapper),
                keyframe_config=KeyframeConfig(window_size=3),
                system_config=SystemConfig(map_capacity=4096, capacity_headroom=256,
                                           async_bootstrap_kfs=bootstrap),
                device="cpu")


def _no_mapper_thread():
    return not any(t.name == "mapper" and t.is_alive() for t in threading.enumerate())


def test_async_mode_tracks():
    slam = _slam()
    rmse = slam.run_async()
    assert np.isfinite(rmse)
    motions = sum(np.linalg.norm(slam.gt_poses[i][1] - slam.gt_poses[i - 1][1])
                  for i in range(1, len(slam.gt_poses)))
    # Async tracking races ahead of mapping with tiny test budgets, so the
    # bound is looser than the synchronous e2e test's (tests/test_async.py).
    assert rmse < 2.0 * motions
    assert int(slam.state.gmap.num_active) > 50
    assert _no_mapper_thread() and slam._defer_overflow_read


def test_async_bootstrap_applies_results_inline():
    slam = _slam(bootstrap=99)
    rmse = slam.run_async()
    assert np.isfinite(rmse)
    for i in slam.kf_list:
        assert i in slam.vis_dict
        assert i in slam.exposures
    # Every event was waited for: applied before the next frame was tracked.
    assert slam.metrics["async_staleness"] == [0] * (len(slam.kf_history) - 1)
    assert slam.metrics["frames_tracked_in_flight"] == 0


def test_async_mapper_failure_propagates():
    slam = _slam(init_itr_num=10, iters_per_kf=2)

    def boom(*a, **k):
        raise ValueError("injected mapper fault")

    slam._mapper_keyframe = boom
    with pytest.raises(RuntimeError, match="mapper thread failed") as info:
        slam.run_async()
    assert isinstance(info.value.__cause__, ValueError)
    assert _no_mapper_thread() and slam._defer_overflow_read


def test_async_with_bootstrap_equals_run():
    """The slab backend (the card's path, through the kernels' plain
    twins): run_async with every keyframe event in the bootstrap window
    against run() on a fresh SLAM."""
    sync = _slam("slab")
    sync.run()
    boot = _slam("slab", bootstrap=99)
    boot.run_async()
    assert sorted(boot.est_poses) == sorted(sync.est_poses) == list(range(6))
    assert boot.kf_history == sync.kf_history and boot.kf_list == sync.kf_list
    for i in sync.est_poses:
        for a, b in zip(boot.est_poses[i], sync.est_poses[i]):
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-6, err_msg=str(i))
    assert int(boot.state.gmap.num_active) == int(sync.state.gmap.num_active)
    torch.testing.assert_close(boot.state.gmap.params["xyz"], sync.state.gmap.params["xyz"],
                               rtol=0, atol=1e-6)


def test_tracker_exception_stops_the_mapper_thread(monkeypatch):
    slam = _slam()
    track = slam.track

    def track_then_fail(idx, frame):
        if idx == 4:
            raise KeyError("injected tracker fault")
        return track(idx, frame)

    monkeypatch.setattr(slam, "track", track_then_fail)
    with pytest.raises(KeyError, match="injected tracker fault"):
        slam.run_async()
    assert _no_mapper_thread()
    assert slam._defer_overflow_read


@pytest.mark.parametrize("defer", [True, False])
def test_overflow_read_per_span_unless_deferred(monkeypatch, defer):
    """run_optimize_map over three spans (densify after iteration 3, so
    spans end at 3 and 6 of 8): deferred, every span is dispatched before
    the one read; not deferred, each span's read follows it."""
    slam = _slam()
    slam.process_frame(0)
    events = []
    span, log_overflow = tm.mapping_span, tm._log_overflow
    monkeypatch.setattr(tm, "mapping_span",
                        lambda *a, **k: (events.append("span"), span(*a, **k))[1])
    monkeypatch.setattr(tm, "_log_overflow",
                        lambda parts: (events.append("read"), log_overflow(parts))[1])
    cfg = dataclasses.replace(slam.mcfg, gaussian_update_every=3, gaussian_update_offset=0)
    state = slam.state._replace(nr_iters=torch.zeros_like(slam.state.nr_iters))
    tm.run_optimize_map(state, slam.intr, cfg, 8, defer_overflow_read=defer)
    assert events == (["span"] * 3 + ["read"] * 3 if defer else ["span", "read"] * 3)
