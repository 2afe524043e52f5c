"""monogs_torch track_frame against monogs_tpu track_frame on the CPU: the
whole tracking slice (projection, binning every rebin_every iterations,
slab compositing and its backward, the loss, Adam and the retraction, the
final render) from the same numpy map and frame. Final R, t and exposure
agree to atol 1e-5; n_iters, converged, visibility and overflow exactly.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from monogs_tpu.ops import lie as jlie
from monogs_tpu.ops import render as jrender
from monogs_tpu.ops.graphics import Intrinsics as JIntr
from monogs_tpu.slam import camera as jcam
from monogs_tpu.slam import tracker as jtrk
from monogs_torch.ops import lie as tlie
from monogs_torch.ops.graphics import Intrinsics as TIntr
from monogs_torch.slam import tracker as ttrk
from monogs_torch.utils.convert import frame_from_numpy, params_from_numpy

torch.set_num_threads(2)   # the test workers share the CPUs (tests/test_torch_system.py)

W, H, N = 64, 48, 150
KW = dict(fx=60.0, fy=60.0, cx=W / 2, cy=H / 2, width=W, height=H)
RHO0 = np.array([0.01, -0.005, 0.008], np.float32)
THETA0 = np.array([0.004, 0.003, -0.005], np.float32)


def _setup(seed=0):
    """Map params (numpy), a noisy ground-truth frame rendered at the
    identity, and the JAX frame moved to a perturbed start pose. The noise
    keeps the L1 losses off their kinks (a render equal to its ground truth
    to the last bit has a zero subgradient in one package and +-1 in the
    other)."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    params = {
        "xyz": np.concatenate([rng.uniform(-0.6, 0.6, (N, 2)),
                               rng.uniform(1.0, 3.0, (N, 1))], 1).astype(f32),
        "log_scales": rng.uniform(-3.0, -2.0, (N, 3)).astype(f32),
        "quats": (rng.normal(size=(N, 4)) + [2.0, 0, 0, 0]).astype(f32),
        "opacity_logit": (rng.normal(size=N) + 1.0).astype(f32),
        "rgb": rng.uniform(size=(N, 3)).astype(f32),
    }
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    gt = jrender.render(jp["xyz"], jnp.exp(jp["log_scales"]), jp["quats"],
                        1.0 / (1.0 + jnp.exp(-jp["opacity_logit"])), jp["rgb"],
                        jnp.eye(3), jnp.zeros(3), JIntr(**KW), tile_capacity=256,
                        backend="ref")
    rgb = np.clip(np.asarray(gt.rgb) + 0.02 * rng.normal(size=(H, W, 3)), 0, 1).astype(f32)
    depth = (np.asarray(gt.depth) * (1 + 0.01 * rng.normal(size=(H, W)))).astype(f32)
    frame = jcam.make_frame(1, jnp.asarray(rgb), jnp.asarray(depth), jnp.eye(4))
    R0, t0 = jlie.apply_pose_delta(frame.R, frame.t, jnp.asarray(RHO0), jnp.asarray(THETA0))
    return params, jcam.with_pose(frame, R0, t0)


def _configs(**kw):
    base = dict(opacity_threshold=0.5, tile_size=16, tile_capacity=256, **kw)
    backend = base.pop("backend", ("pallas", "slab"))
    return (jtrk.TrackerConfig(backend=backend[0], **base),
            ttrk.TrackerConfig(backend=backend[1], **base))


def _track_both(params, frame, **kw):
    cj, ct = _configs(**kw)
    active = np.ones(N, bool)
    rj = jtrk.track_frame({k: jnp.asarray(v) for k, v in params.items()},
                          jnp.asarray(active), frame, JIntr(**KW), cj)
    rt = ttrk.track_frame(params_from_numpy(params, "cpu"), torch.as_tensor(active),
                          frame_from_numpy(frame, "cpu"), TIntr(**KW), ct)
    return rj, rt


def _assert_results_match(rj, rt):
    g = lambda r, f: np.asarray(getattr(r, f)) if not torch.is_tensor(getattr(r, f)) \
        else getattr(r, f).numpy()  # noqa: E731
    for f in ("R", "t", "exposure_a", "exposure_b", "median_depth"):
        np.testing.assert_allclose(g(rt, f), g(rj, f), atol=1e-5, err_msg=f)
    for f in ("n_iters", "converged", "visibility", "overflow", "overflow_parts"):
        np.testing.assert_array_equal(g(rt, f), g(rj, f), err_msg=f)
    np.testing.assert_allclose(g(rt, "render_opacity"), g(rj, "render_opacity"), atol=1e-5)
    np.testing.assert_allclose(g(rt, "render_depth"), g(rj, "render_depth"), atol=1e-4)
    np.testing.assert_allclose(g(rt, "host_stats"), g(rj, "host_stats"), atol=1e-5)


@pytest.fixture(scope="module")
def scene():
    return _setup()


@pytest.mark.parametrize("backend", [("pallas", "slab"), ("ref", "ref")])
def test_track_frame_matches_jax(scene, backend):
    """16 forced iterations: two rebin segments of 8."""
    rj, rt = _track_both(*scene, max_iters=16, convergence_threshold=0.0,
                         backend=backend)
    assert int(rt.n_iters) == 16 and not bool(rt.converged)
    _assert_results_match(rj, rt)


def test_track_frame_convergence_exit_matches_jax(scene):
    rj, rt = _track_both(*scene, max_iters=40, convergence_threshold=2e-3)
    assert bool(rj.converged) and int(rj.n_iters) < 40
    _assert_results_match(rj, rt)


def test_track_frame_reduces_pose_error(scene):
    params, frame = scene
    _, ct = _configs(max_iters=100)
    res = ttrk.track_frame(params_from_numpy(params, "cpu"), None,
                           frame_from_numpy(frame, "cpu"), TIntr(**KW), ct)
    err = lambda R, t: float(np.abs(R - np.eye(3)).max() + np.abs(t).max())  # noqa: E731
    assert err(res.R.numpy(), res.t.numpy()) < 0.5 * err(np.asarray(frame.R), np.asarray(frame.t))


def test_tracker_config_defaults_match_jax():
    a = dataclasses.asdict(jtrk.TrackerConfig())
    b = dataclasses.asdict(ttrk.TrackerConfig())
    assert a.pop("backend") == "pallas" and b.pop("backend") == "slab"
    assert a == b


def test_adam4_matches_jax():
    rng = np.random.default_rng(1)
    sj, st = jtrk._adam4_init(), ttrk._adam4_init("cpu")
    lrs = (0.001, 0.003, 0.01, 0.01)
    for _ in range(5):
        g = [rng.normal(size=s).astype(np.float32) for s in (3, 3, (), ())]
        uj, sj = jtrk._adam4_update(tuple(map(jnp.asarray, g)), sj, lrs, 1e-8)
        ut, st = ttrk._adam4_update(tuple(torch.as_tensor(x) for x in g), st, lrs, 1e-8)
        for a, b in zip(uj, ut):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-5, atol=1e-9)
    assert int(st.step) == int(sj.step) == 5


def test_unpack_host_stats_matches_jax():
    s = np.arange(22, dtype=np.float32) / 7.0
    a, b = jtrk.unpack_host_stats(s), ttrk.unpack_host_stats(torch.as_tensor(s))
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(np.asarray(b[k]), np.asarray(a[k]), err_msg=k)


def test_conversion_keeps_keys_and_dtypes(scene):
    params, frame = scene
    tp = params_from_numpy(params, "cpu")
    assert set(tp) == set(params) and all(v.dtype == torch.float32 for v in tp.values())
    tf = frame_from_numpy(frame, "cpu")
    assert tf.mask.dtype == torch.bool and tf.frame_idx.dtype == torch.int32
    np.testing.assert_array_equal(tf.R.numpy(), np.asarray(frame.R))
    R, t = tlie.apply_pose_delta(tf.R, tf.t, torch.zeros(3), torch.zeros(3))
    np.testing.assert_allclose(R.numpy(), np.asarray(frame.R), atol=1e-7)
