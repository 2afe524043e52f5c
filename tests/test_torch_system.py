"""monogs_torch's synchronous SLAM system against monogs_tpu's on the CPU.

Steps: the map initialisation and the first three frames of
tests/test_slam_e2e.py's CFG, processed by both packages in lockstep on
the same frames (the JAX dataset's). Before each frame the port's SLAM is
set to the JAX SLAM's state (`utils.convert.slam_from_numpy`), and the
random numbers the JAX events draw from their keys are fed to the port's
events (`scores_u` / `depth_noise` for extend, `split_noise` for densify),
so both take each step from one point. They must agree exactly on the
keyframe decisions, the keyframe list, the window slots and the active
mask, and on the tracked poses within 1e-4 (both tracker loops run the
dense oracle on one map and one frame; the JAX suite holds one rendered
frame to 1e-5); and on what each keyframe event writes back: the window
keyframes' poses and exposures within 1e-4, the map's parameters within
the tolerances stated at `_check_mapper_result`.

The port's whole `run()` on that CFG is tests/test_torch_system_run.py,
and its command line tests/test_torch_cli.py: each SLAM run has a file,
and so a test worker, of its own.
"""

import collections
import os

import jax
import numpy as np
import pytest
import torch

from monogs_tpu.data.synthetic import SyntheticDataset as JDataset
from monogs_tpu.slam import keyframes as jkf
from monogs_tpu.slam import mapper as jm
from monogs_tpu.slam import system as jsys
from monogs_tpu.slam import tracker as jtr
from monogs_tpu.utils.config import SystemConfig as JSystemConfig
from monogs_torch.ops.graphics import Intrinsics as TIntr
from monogs_torch.slam import keyframes as tkf
from monogs_torch.slam import mapper as tm
from monogs_torch.slam import system as tsys
from monogs_torch.slam import tracker as ttr
from monogs_torch.utils.config import SystemConfig as TSystemConfig
from monogs_torch.utils.convert import slam_from_numpy

# The tier-1 run puts several pytest workers on one machine, and torch at
# its default takes every core in each of them (beside JAX's own pool),
# which oversubscribes the machine: each port test file that runs a SLAM,
# a mapper or a render loop caps it at 2 intra-op threads (the setting is
# per process, and a worker runs many files).
torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# tests/test_slam_e2e.py's CFG and budgets.
CFG = {
    "Dataset": {
        "type": "synthetic",
        "Calibration": {
            "width": 96, "height": 64,
            "fx": 80.0, "fy": 80.0, "cx": 48.0, "cy": 32.0,
            "depth_scale": 1.0,
        },
        "Objects": {"static": [0], "dynamic": [], "masked": []},
        "synthetic": {
            "n_frames": 8, "n_gaussians": 800, "seed": 3,
            "motion_scale": 0.01,
        },
    },
}
TRACK = dict(tile_size=16, max_iters=40, tile_capacity=256, max_dup=32,
             opacity_threshold=0.5)
MAP = dict(tile_size=16, init_itr_num=160, init_gaussian_update=50,
           init_gaussian_reset=60, iters_per_kf=30, gaussian_update_every=60,
           gaussian_update_offset=10, tile_capacity=256, max_dup=32)   # window 4: below
SYSTEM = dict(map_capacity=8192, capacity_headroom=512, seed=0)


@pytest.fixture(autouse=True)
def _no_frame_cache(monkeypatch):
    monkeypatch.setenv("MONOGS_SYNTH_CACHE", "0")


def _configs(pkg, backend, **map_kw):
    tr, mp, kf, sc = {"jax": (jtr, jm, jkf, JSystemConfig),
                      "torch": (ttr, tm, tkf, TSystemConfig)}[pkg]
    return dict(tracker_config=tr.TrackerConfig(backend=backend, **TRACK),
                mapper_config=mp.MapperConfig(backend=backend, **{**MAP, **map_kw}),
                keyframe_config=kf.KeyframeConfig(window_size=4, kf_interval=1),
                system_config=sc(**SYSTEM))


class _SameFrames:
    """The JAX dataset's frames (numpy) with the port's Intrinsics."""

    def __init__(self, ds):
        self._ds = ds
        self.intrinsics = TIntr(**ds.intrinsics._asdict())
        self.nr_objects = ds.nr_objects

    def __len__(self):
        return len(self._ds)

    def __getitem__(self, idx):
        return self._ds[idx]


def _feed_draws(monkeypatch):
    """Record the draws of every JAX extend and densify event and hand
    them, in order, to the port's events."""
    extend_q, densify_q = collections.deque(), collections.deque()
    j_extend, j_densify = jsys.extend_event, jm.densify_event
    t_extend, t_densify = tsys.extend_event, tm.densify_event

    def jax_extend(state, frame, kf_idx, intr, cfg, init):
        _, sub = jax.random.split(state.rng)
        k_scores, k_depth = jax.random.split(sub)
        extend_q.append((np.array(jax.random.uniform(k_scores, (intr.height * intr.width,))),
                         np.array(jax.random.normal(k_depth, (intr.height, intr.width)))))
        return j_extend(state, frame, kf_idx, intr, cfg, init)

    def jax_densify(state, cfg, init_phase):
        _, sub = jax.random.split(state.rng)
        densify_q.append(np.array(jax.random.normal(sub, (2, state.gmap.capacity, 3))))
        return j_densify(state, cfg, init_phase=init_phase)

    def torch_extend(*args, **kw):
        scores_u, depth_noise = extend_q.popleft()
        return t_extend(*args, **kw, scores_u=torch.as_tensor(scores_u),
                        depth_noise=torch.as_tensor(depth_noise))

    def torch_densify(state, cfg, init_phase):
        return t_densify(state, cfg, init_phase,
                         split_noise=torch.as_tensor(densify_q.popleft()))

    monkeypatch.setattr(jsys, "extend_event", jax_extend)
    monkeypatch.setattr(jm, "densify_event", jax_densify)
    monkeypatch.setattr(tsys, "extend_event", torch_extend)
    monkeypatch.setattr(tm, "densify_event", torch_densify)
    return extend_q, densify_q


# What a keyframe event writes, port against JAX. Window poses and
# exposures: 1e-4 (the tracked poses' tolerance; neighbouring keyframes'
# poses and exposures differ by 1e-2 or more, so a wrong slot or a
# write-back to the wrong keyframe fails it). Active Gaussians' xyz, rgb,
# log-scales and opacity logits after the mapping iterations: the median
# per-Gaussian difference within 1e-4 and 99% of them within 5e-3. Not
# every one: Adam at eps 1e-15 turns rounding in a near-zero gradient into
# a full step of either sign, and a seed far out on a depth edge takes a
# kNN scale near e^9, where float32 moves its log-scale by up to 1e-1.
# (Measured on the CPU: medians to 8e-6, 99th percentiles to 8e-4.)
KF_TOL = 1e-4
MAP_MEDIAN_TOL, MAP_Q99_TOL = 1e-4, 5e-3


def _check_mapper_result(ts, js, idx):
    for i in js.kf_list:
        for a, b in zip(ts.est_poses[i], js.est_poses[i]):
            np.testing.assert_allclose(a, b, atol=KF_TOL, err_msg=f"frame {idx} kf {i}")
        np.testing.assert_allclose(np.asarray(ts.exposures[i], np.float64),
                                   np.asarray([float(np.asarray(e)) for e in js.exposures[i]]),
                                   atol=KF_TOL, err_msg=f"frame {idx} kf {i}")
    act = np.asarray(js.state.gmap.active)
    assert act.any(), idx
    for k in ("xyz", "rgb", "log_scales", "opacity_logit"):
        d = np.abs(ts.state.gmap.params[k].detach().numpy()[act]
                   - np.asarray(js.state.gmap.params[k])[act]).reshape(int(act.sum()), -1)
        d = d.max(-1)
        assert np.median(d) <= MAP_MEDIAN_TOL and np.quantile(d, 0.99) <= MAP_Q99_TOL, \
            (idx, k, float(np.median(d)), float(np.quantile(d, 0.99)), float(d.max()))


def test_steps_match_jax(monkeypatch):
    """Init (55 iterations: densify events after iterations 1 and 51) and
    frames 1-3 (5 mapping iterations each; frame 3's end with a densify
    after iteration 70), every frame a keyframe: frames 1-2 build the
    window by permutation, frame 3 cold, and frame 3 fills the window of 4,
    so its keyframe event takes the first covisibility prune (floor
    -2^31). After each frame: the decisions, the keyframe list, the window
    slots and the active mask exactly, the tracked pose within 1e-4, and
    (frames 1-3) what the keyframe event wrote (`_check_mapper_result`).
    The map after the 55 init iterations is not compared: over that many
    Adam steps the few Gaussians that step apart move their neighbours'
    gradients too. Then, from one state, the slab-demand probe, the
    re-probe's rows and the map growth."""
    extend_q, densify_q = _feed_draws(monkeypatch)
    budgets = dict(init_itr_num=55, iters_per_kf=5)
    jds = JDataset(CFG)
    js = jsys.SLAM(jds, **_configs("jax", "ref", **budgets))
    ts = tsys.SLAM(_SameFrames(jds), **_configs("torch", "ref", **budgets), device="cpu")
    n_densify = 0
    for idx in range(4):
        if idx == 3:
            # Frame 3 takes the cold window build (slots unknown: every
            # keyframe fetched at its estimated pose); 1-2 the permutation.
            js._window_slots = None
        if idx:
            slam_from_numpy(js, ts, "cpu")
        rj = js.process_frame(idx)
        n_densify += len(densify_q)
        rt = ts.process_frame(idx)
        assert not extend_q and not densify_q, idx      # every draw consumed
        assert rt == rj, idx
        assert ts.kf_list == js.kf_list, idx
        assert ts._window_slots == js._window_slots, idx
        assert ts.first_time_pruned == js.first_time_pruned, idx
        np.testing.assert_array_equal(ts.state.gmap.active.numpy(),
                                      np.asarray(js.state.gmap.active), err_msg=str(idx))
        for a, b in zip(ts._raw_poses[idx], js._raw_poses[idx]):
            np.testing.assert_allclose(a, b, atol=1e-4, err_msg=str(idx))
        if idx == 0:
            assert (ts.tcfg.entry_capacity, ts.mcfg.entry_capacity) == (
                js.tcfg.entry_capacity, js.mcfg.entry_capacity)
        else:
            _check_mapper_result(ts, js, idx)
    assert n_densify == 3 and ts.kf_list == [3, 2, 1, 0] and ts.first_time_pruned

    # From the same state: the slab-demand probe behind the capacity
    # re-probes, and the map growth at low headroom.
    slam_from_numpy(js, ts, "cpu")
    frame_t, frame_j = ts.frames[3], js.frames[3]
    for name in ("tcfg", "mcfg"):
        cfg_t, cfg_j = getattr(ts, name), getattr(js, name)
        padded_j, _ = jsys._demand_probe_core(
            js.state.gmap.params, js.state.gmap.active, frame_j.R, frame_j.t,
            np.zeros(3, np.float32), intr=js.intr, tile_size=cfg_j.tile_size,
            tile_capacity=cfg_j.tile_capacity, max_dup=cfg_j.max_dup,
            max_dup_gen=cfg_j.max_dup_gen, isotropic=cfg_j.isotropic)
        assert ts._entry_demand(cfg_t, frame_t)[0] == int(padded_j) > 0
        small = dict(entry_capacity=512)
        assert ts._required_rows(type(cfg_t)(**{**vars(cfg_t), **small}), frame_t) == \
            js._required_rows(type(cfg_j)(**{**vars(cfg_j), **small}), frame_j) > 512
    for slam in (ts, js):
        slam.scfg.capacity_headroom = slam.state.gmap.capacity
        slam._maybe_grow()
    assert ts.state.gmap.capacity == js.state.gmap.capacity == 2 * SYSTEM["map_capacity"]
    np.testing.assert_array_equal(ts.state.gmap.active.numpy(),
                                  np.asarray(js.state.gmap.active))


def test_window_host_unpack_and_const_velocity_match_jax():
    """The keyframe event's one-read unpack, and the constant-velocity
    tracking init, on the same numpy inputs: exact."""
    rng = np.random.default_rng(0)
    pack = rng.normal(size=6 * 14).astype(np.float32)
    ut, uj = tm.unpack_window_host(torch.as_tensor(pack), 6), jm.unpack_window_host(pack, 6)
    assert ut.keys() == uj.keys()
    for k in ut:
        np.testing.assert_array_equal(ut[k], uj[k])
    poses = [(np.linalg.qr(rng.normal(size=(3, 3)))[0].astype(np.float32),
              rng.normal(size=3).astype(np.float32)) for _ in range(3)]
    for base in (None, poses[2]):
        for a, b in zip(tsys.const_velocity_init(poses[0], poses[1], base),
                        jsys.const_velocity_init(poses[0], poses[1], base)):
            np.testing.assert_array_equal(a, b)
