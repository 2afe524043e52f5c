"""monogs_torch's monocular system path (no sensor depth: the seed depth is
synthesised, the tracking loss has no depth term) on the CPU.

Run: the port of tests/test_slam_e2e.py::test_monocular_slam_runs at that
test's budgets, bounds and backend (the dense oracle): the whole `run()`
on 5 frames must not diverge (ATE finite and under twice the summed
motion: the scale is unobservable), must build a map of over 100
Gaussians and render it at over 10 dB.

Lockstep against the JAX package on the same frames (the JAX dataset's):
from the JAX SLAM's state after its map initialisation (trimmed to 55
iterations, as the Steps test trims its own), carried across
with `utils.convert.slam_from_numpy`, frame 1 (depth-less) tracks to the
same pose within 1e-4 (the Steps test's tolerance,
tests/test_torch_system.py); and frame 0's monocular extend, with the
draws of the JAX event fed to the port's, seeds the same Gaussians: the
active mask exactly, their parameters within 1e-5.
"""

import copy

import numpy as np
import torch

from monogs_tpu.data.synthetic import SyntheticDataset as JDataset
from monogs_tpu.slam import camera as jcam
from monogs_tpu.slam import keyframes as jkf
from monogs_tpu.slam import mapper as jm
from monogs_tpu.slam import system as jsys
from monogs_tpu.slam import tracker as jtr
from monogs_tpu.utils.config import SystemConfig as JSystemConfig
from monogs_torch.slam import camera as tcam
from monogs_torch.slam import keyframes as tkf
from monogs_torch.slam import mapper as tm
from monogs_torch.slam import system as tsys
from monogs_torch.slam import tracker as ttr
from monogs_torch.utils.config import SystemConfig as TSystemConfig
from monogs_torch.utils.convert import slam_from_numpy
from test_torch_system import CFG, _feed_draws, _no_frame_cache, _SameFrames  # noqa: F401

torch.set_num_threads(2)   # the test workers share the CPUs (tests/test_torch_system.py)

MONO_CFG = copy.deepcopy(CFG)
MONO_CFG["Dataset"]["synthetic"].update({"n_frames": 5, "use_depth": False})


def _configs(pkg, init_itr_num=120):
    """tests/test_slam_e2e.py::test_monocular_slam_runs's configs (its
    MapperConfig's unread window_size left out)."""
    tr, mp, kf, sc = {"jax": (jtr, jm, jkf, JSystemConfig),
                      "torch": (ttr, tm, tkf, TSystemConfig)}[pkg]
    return dict(
        tracker_config=tr.TrackerConfig(tile_size=16, max_iters=25, tile_capacity=128,
                                        max_dup=32, backend="ref", opacity_threshold=0.5),
        mapper_config=mp.MapperConfig(
            tile_size=16, init_itr_num=init_itr_num, init_gaussian_update=50,
            init_gaussian_reset=200, iters_per_kf=20, gaussian_update_every=500,
            gaussian_update_offset=10, tile_capacity=128, max_dup=32, backend="ref",
            monocular=True, isotropic=True, prune_coviz=1),
        keyframe_config=kf.KeyframeConfig(window_size=3),
        system_config=sc(map_capacity=8192, capacity_headroom=512))


def test_monocular_slam_runs():
    from monogs_torch.data.synthetic import SyntheticDataset

    slam = tsys.SLAM(SyntheticDataset(MONO_CFG, device="cpu"), **_configs("torch"),
                     device="cpu")
    assert slam.mcfg.monocular and slam.dataset[0].get("depth") is None
    rmse = slam.run()
    assert np.isfinite(rmse)
    motions = sum(np.linalg.norm(slam.gt_poses[i][1] - slam.gt_poses[i - 1][1])
                  for i in range(1, len(slam.gt_poses)))
    assert rmse < 2.0 * motions  # not diverged (mono scale is ambiguous)
    assert int(slam.state.gmap.num_active) > 100
    res = slam.eval_rendering(every=2)
    assert res["mean_psnr"] > 10.0, res


def test_monocular_init_extend_and_tracking_match_jax(monkeypatch):
    """The JAX init at the Steps test's trimmed 55 iterations (one densify
    event, after iteration 51; tests/test_torch_system.py)."""
    jds = JDataset(MONO_CFG)
    js = jsys.SLAM(jds, **_configs("jax", init_itr_num=55))
    ts = tsys.SLAM(_SameFrames(jds), **_configs("torch", init_itr_num=55), device="cpu")

    # Frame 1, tracked without depth from the JAX SLAM's initialised state.
    js.process_frame(0)
    slam_from_numpy(js, ts, "cpu")
    fj, ft = js._load_frame(1), ts._load_frame(1)
    assert not np.asarray(fj.depth).any() and not ft.depth.any()
    js.track(1, fj)
    ts.track(1, ft)
    for a, b in zip(ts._raw_poses[1], js._raw_poses[1]):
        np.testing.assert_allclose(a, b, atol=1e-4)
    moved = np.abs(js._raw_poses[1][1] - js._raw_poses[0][1]).max()
    assert moved > 1e-3       # the tracked pose left frame 0's

    # Frame 0's monocular extend on a fresh state, the JAX draws fed in.
    extend_q, _ = _feed_draws(monkeypatch)
    fj, ft = js._load_frame(0), ts._load_frame(0)
    sj = jm.init_mapper_state(8192, 1, jcam.window_from_list([fj], 3))
    st = tm.init_mapper_state(8192, 1, tcam.window_from_list([ft], 3))
    sj, (n_j, _) = jsys.extend_event(sj, fj, 0, js.intr, js.mcfg, True)
    st, (n_t, _) = tsys.extend_event(st, ft, 0, ts.intr, ts.mcfg, init=True)
    assert not extend_q and int(n_t) == int(n_j) > 100
    act = np.asarray(sj.gmap.active)
    np.testing.assert_array_equal(st.gmap.active.numpy(), act)
    for k, v in st.gmap.params.items():
        np.testing.assert_allclose(v.numpy()[act], np.asarray(sj.gmap.params[k])[act],
                                   atol=1e-5, rtol=0, err_msg=k)
