"""monogs_torch's colour refinement against monogs_tpu's on the CPU: one
refinement iteration (`_refine_iter` against JAX's `refine_step`) in
colours-only and all-params mode, a span of 8 (`refine_span`, binned once),
the port of tests/test_mapping_exit.py::test_refine_colors_only_freezes_geometry,
and `SLAM.refine`'s keyframe draws in both modes. Both packages start from
one state (`utils.convert.mapper_state_from_numpy` / `slam_from_numpy`);
the JAX side renders through Pallas in interpret mode, as the JAX suite
runs it on the CPU, and the port through the slab kernels' plain twins.

Tolerances. After one iteration from warm Adam moments (mu 0.01, nu 0.001
on every leaf, as after a mapping run; the step is then a smooth function
of the gradient) the parameters within 1e-5; the first moments as
gradients (mu - b1 mu0) / (1 - b1) at rtol 2e-3 / atol 1e-6, plus 1e-4 of
the leaf's scale for the leaves reached through the screen means and
conics (the Pallas backward's pixel moments cancel; ROADMAP Queue 3); the
frozen leaves' moments, nr_iters, the Adam step and the overflow exactly.
After a span of 8 iterations: the active Gaussians' parameters by median
per-Gaussian difference 1e-4 and 99th percentile 5e-3 (ROADMAP Queue 3
item 4).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from monogs_tpu.ops.graphics import Intrinsics as JIntr
from monogs_tpu.slam import mapper as jm
from monogs_tpu.slam import system as jsys
from monogs_torch.ops import render as trender
from monogs_torch.ops.graphics import Intrinsics as TIntr
from monogs_torch.slam import mapper as tm
from monogs_torch.slam import system as tsys
from monogs_torch.utils.convert import (
    frame_from_numpy,
    mapper_state_from_numpy,
    slam_from_numpy,
)
from test_torch_mapper import INTR, MOMENT_LEAVES, _cfgs, _close_grads, _state

torch.set_num_threads(2)   # the test workers share the CPUs (tests/test_torch_system.py)

MU0, NU0 = 0.01, 0.001
MAP_MEDIAN_TOL, MAP_Q99_TOL = 1e-4, 5e-3


def _warm(js):
    """The JAX state with warm moments on every leaf, and its keyframe 0."""
    adam = js.adam._replace(mu=jax.tree.map(lambda x: jnp.full_like(x, MU0), js.adam.mu),
                            nu=jax.tree.map(lambda x: jnp.full_like(x, NU0), js.adam.nu))
    js = js._replace(adam=adam)
    return js, jax.tree.map(lambda x: x[0], js.window.frames)


@pytest.mark.parametrize("colors_only", [True, False])
def test_refine_iter_matches_jax(colors_only):
    js, jf = _warm(_state())
    cj, ct = _cfgs(refine_colors_only=colors_only)
    sj, ov_j = jm.refine_step(js, jf, JIntr(**INTR), cj)
    st, ov_t = tm._refine_iter(mapper_state_from_numpy(js, "cpu"), frame_from_numpy(jf, "cpu"),
                               TIntr(**INTR), ct)
    assert int(ov_t) == int(ov_j)
    assert int(st.nr_iters) == int(sj.nr_iters) == 1
    assert int(st.adam.step) == int(sj.adam.step) == 1
    moved = tm.REFINE_LEAVES if colors_only else tuple(st.gmap.params)
    for k, p in st.gmap.params.items():
        pj = np.asarray(sj.gmap.params[k])
        np.testing.assert_allclose(p.numpy(), pj, atol=1e-5, rtol=0, err_msg=k)
        mu_t, mu_j = st.adam.mu[k].numpy(), np.asarray(sj.adam.mu[k])
        if k in moved:
            g = [(m - np.float32(0.9 * MU0)) / np.float32(0.1) for m in (mu_t, mu_j)]
            _close_grads(*g, k, k in MOMENT_LEAVES)
        else:
            # Frozen: no gradient, lr 0; the moments still decay as JAX's.
            np.testing.assert_array_equal(p.numpy(), np.asarray(js.gmap.params[k]), err_msg=k)
            np.testing.assert_array_equal(mu_t, mu_j, err_msg=k)
            np.testing.assert_array_equal(st.adam.nu[k].numpy(), np.asarray(sj.adam.nu[k]),
                                          err_msg=k)
            assert (mu_t == np.float32(0.9) * np.float32(MU0)).all(), k


def test_refine_span_matches_jax_and_bins_once(monkeypatch):
    js, jf = _warm(_state())
    cj, ct = _cfgs()
    calls = {"mapper": 0, "render": 0}

    def counted(where, fn):
        def call(*a, **kw):
            calls[where] += 1
            return fn(*a, **kw)
        return call

    # Each caller imports tile_bin by name: count it at both names.
    monkeypatch.setattr(tm, "tile_bin", counted("mapper", tm.tile_bin))
    monkeypatch.setattr(trender, "tile_bin", counted("render", trender.tile_bin))
    sj, ov_j = jm.refine_span(js, jf, JIntr(**INTR), cj, 8)
    st, ov_t = tm.refine_span(mapper_state_from_numpy(js, "cpu"), frame_from_numpy(jf, "cpu"),
                              TIntr(**INTR), ct, 8)
    assert calls == {"mapper": 1, "render": 0}
    assert int(ov_t) == int(ov_j) > 0      # the span's worst render overflows
    assert int(st.nr_iters) == int(sj.nr_iters) == 8
    act = np.asarray(js.gmap.active)
    for k in tm.REFINE_LEAVES:
        d = np.abs(st.gmap.params[k].numpy()[act] - np.asarray(sj.gmap.params[k])[act])
        d = d.reshape(int(act.sum()), -1).max(-1)
        assert np.median(d) <= MAP_MEDIAN_TOL and np.quantile(d, 0.99) <= MAP_Q99_TOL, \
            (k, float(np.median(d)), float(np.quantile(d, 0.99)))
        moved = np.abs(st.gmap.params[k].numpy() - np.asarray(js.gmap.params[k]))[act]
        assert np.median(moved) > MAP_MEDIAN_TOL, k     # the check is not vacuous
    for k in set(st.gmap.params) - set(tm.REFINE_LEAVES):
        np.testing.assert_array_equal(st.gmap.params[k].numpy(),
                                      np.asarray(js.gmap.params[k]), err_msg=k)


def test_refine_colors_only_freezes_geometry():
    """Port of tests/test_mapping_exit.py::test_refine_colors_only_freezes_geometry:
    geometry must not move in colours-only mode, under warm Adam moments
    (so the freeze must be lr 0, not only zero gradients); rgb must move;
    all-params mode must move the geometry."""
    from test_mapping_exit import _cfg, _make_state

    js, intr = _make_state()
    js, jf = _warm(js)
    state, frame = mapper_state_from_numpy(js, "cpu"), frame_from_numpy(jf, "cpu")
    ti = TIntr(**intr._asdict())
    common = {k: getattr(_cfg(), k) for k in ("tile_size", "tile_capacity", "max_dup")}
    st, _ = tm.refine_step(state, frame, ti, tm.MapperConfig(backend="ref", **common))
    for k in ("xyz", "log_scales", "quats"):
        assert torch.equal(st.gmap.params[k], state.gmap.params[k]), \
            f"{k} moved in colours-only refine"
    assert not torch.allclose(st.gmap.params["rgb"], state.gmap.params["rgb"]), \
        "rgb did not move: refine did nothing"
    st2, _ = tm.refine_step(state, frame, ti,
                            tm.MapperConfig(backend="ref", refine_colors_only=False, **common))
    assert not torch.allclose(st2.gmap.params["xyz"], state.gmap.params["xyz"]), \
        "all-params refine should move geometry"


KF = (0, 3, 4, 6, 9)


def _record(log, kind):
    """A stand-in for refine_span / refine_chunk / refine_step that records
    the frame indices it was handed and leaves the state as it was."""
    def call(state, frames, intr, cfg, *n):
        idx = np.asarray(frames.frame_idx).reshape(-1).tolist()
        log.append((kind, [int(i) for i in idx], n))
        if kind == "torch":
            ea = frames.exposure_a.reshape(-1).tolist()
            log[-1] += (ea,)
        return state, (jnp.int32(0) if kind == "jax" else torch.zeros((), dtype=torch.int32))
    return call


@pytest.mark.parametrize("colors_only", [True, False])
def test_refine_draws_the_keyframes_jax_draws(monkeypatch, colors_only):
    """SLAM.refine on both packages from one small state, with the span /
    chunk / step functions replaced by recorders: the same keyframes in the
    same order and grouping (colours-only: one draw per span of
    min(8, left); all-params: 8 per chunk, then single steps), each staged
    at its estimated pose and exposure."""
    from test_torch_system import CFG, _configs

    from monogs_tpu.data.synthetic import SyntheticDataset as JDataset
    from test_torch_system import _SameFrames

    log = []
    for mod, kind in ((jsys, "jax"), (tsys, "torch")):
        for name in ("refine_span", "refine_chunk", "refine_step"):
            monkeypatch.setattr(mod, name, _record(log, kind))
    jds = JDataset(CFG)
    js = jsys.SLAM(jds, **_configs("jax", "ref", refine_colors_only=colors_only))
    ts = tsys.SLAM(_SameFrames(jds), **_configs("torch", "ref", refine_colors_only=colors_only),
                   device="cpu")
    st, _ = _warm(_state())
    wf = st.window.frames
    js.state = st
    js.kf_history = set(KF)
    js.frames = {i: jax.tree.map(lambda x: x[n % 3], wf)._replace(frame_idx=jnp.int32(i))
                 for n, i in enumerate(KF)}
    js.est_poses = {i: (np.eye(3, dtype=np.float32), np.full(3, 0.01 * i, np.float32))
                    for i in KF}
    js.exposures = {i: (0.1 * i, -0.01 * i) for i in KF}
    slam_from_numpy(js, ts, "cpu")
    iters = 37
    js.refine(iters=iters)
    ts.refine(iters=iters)
    jlog = [e for e in log if e[0] == "jax"]
    tlog = [e for e in log if e[0] == "torch"]
    assert [(i, n) for _, i, n in jlog] == [(i, n) for _, i, n, _ in tlog]
    draws = [i for _, idx, _ in jlog for i in idx]
    assert len(draws) == (5 if colors_only else iters) and set(draws) <= set(KF)
    if colors_only:
        assert [n for _, _, n in jlog] == [(8,)] * 4 + [(5,)]
    else:
        assert [len(i) for _, i, _ in jlog] == [8] * 4 + [1] * 5
    for _, idx, _, ea in tlog:
        np.testing.assert_allclose(ea, [0.1 * i for i in idx], rtol=1e-6)
    assert ts.metrics["refine_overflow_max"] == js.metrics["refine_overflow_max"] == 0
