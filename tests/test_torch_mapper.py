"""monogs_torch's mapper against monogs_tpu's on the CPU: one mapping step
(at init and after), the span loop's trip counts and convergence exit (the
port of tests/test_mapping_exit.py across packages, both backends), the
cadence driver `run_optimize_map` with a densify event, and the events
visibility_pass and covisibility_prune. Both packages start from one state
(`utils.convert.mapper_state_from_numpy`).

Tolerances. The loss 1e-5 relative. The gradients before Adam, read from
the first Adam moments (mu = 0.1 g after one step from zero moments):
rtol 2e-3 / atol 1e-6, plus 1e-4 of the leaf's scale for the leaves
reached through the screen means and conics (the Pallas backward's pixel
moments cancel; ROADMAP Queue 3). A first Adam step moves a parameter by
about lr sign(g), so a gradient near 0 whose sign differs between the
packages moves it by 2 lr: parameters and poses after a step are compared
at 1e-6 only where |g| clears 1e-3 of the leaf's scale. Integer state
(trip counts, denom, the active mask, densify counts) exact.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from monogs_tpu.ops import lie as jlie
from monogs_tpu.ops.graphics import Intrinsics as JIntr
from monogs_tpu.slam import camera as jcam
from monogs_tpu.slam import mapper as jm
from monogs_torch.ops.graphics import Intrinsics as TIntr
from monogs_torch.slam import mapper as tm
from monogs_torch.utils.convert import mapper_state_from_numpy

W, H, C, NL, WN = 64, 48, 512, 300, 3
INTR = dict(fx=60.0, fy=60.0, cx=W / 2, cy=H / 2, width=W, height=H)
MOMENT_LEAVES = ("xyz", "log_scales", "quats")


def _np(x):
    return x.detach().numpy() if torch.is_tensor(x) else np.asarray(x)


def _state(seed=0, n_live=NL):
    """A JAX MapperState: WN keyframes of random images at small poses and a
    map of n_live random Gaussians in front of them."""
    rng = np.random.default_rng(seed)
    frames = []
    for i in range(WN):
        R = np.asarray(jlie.so3_exp(jnp.asarray([0.0, 0.02 * i, 0.01 * i])))
        pose = np.eye(4, dtype=np.float32)
        pose[:3, :3], pose[:3, 3] = R, [0.05 * i, 0, 0]
        frames.append(jcam.make_frame(
            i, jnp.asarray(rng.uniform(size=(H, W, 3)), jnp.float32),
            jnp.asarray(rng.uniform(1, 3, (H, W)), jnp.float32), jnp.asarray(pose)))
    st = jm.init_mapper_state(C, 1, jcam.window_from_list(frames, WN))
    params = {"xyz": np.concatenate([rng.uniform(-0.5, 0.5, (C, 2)),
                                     rng.uniform(1, 3, (C, 1))], 1),
              "log_scales": rng.uniform(-3.5, -2.5, (C, 3)),
              "quats": rng.normal(size=(C, 4)) + [2, 0, 0, 0],
              "opacity_logit": rng.normal(size=C), "rgb": rng.uniform(size=(C, 3))}
    params = {k: jnp.asarray(v, jnp.float32) for k, v in params.items()}
    return st._replace(gmap=st.gmap._replace(params=params, active=jnp.arange(C) < n_live))


def _cfgs(backends=("pallas", "slab"), **kw):
    common = dict(tile_size=16, tile_capacity=256, **kw)
    return jm.MapperConfig(backend=backends[0], **common), \
        tm.MapperConfig(backend=backends[1], **common)


def _close_grads(gt, gj, name, moment):
    scale = np.abs(gj).max()
    floor = 1e-4 * scale if moment else 0.0
    bad = np.abs(gt - gj) > 1e-6 + floor + 2e-3 * np.abs(gj)
    assert not bad.any(), (name, np.argwhere(bad)[:5], gt[bad][:5], gj[bad][:5])
    assert scale > 0, name


@pytest.mark.parametrize("init", [False, True])
def test_mapping_step_matches_jax(init):
    js = _state()
    cj, ct = _cfgs()
    sj, aj = jm.mapping_step(js, JIntr(**INTR), cj, init)
    ts = mapper_state_from_numpy(js, "cpu")
    ti = TIntr(**INTR)
    st, at, (g_params, *_) = tm._mapping_iter(ts, ti, ct, init, tm.window_bins(ts, ti, ct),
                                              tm._tile_window_gt(ts.window, ti, ct))
    np.testing.assert_allclose(float(at.loss), float(aj.loss), rtol=1e-5)
    active = np.asarray(js.gmap.active)
    for k, g in g_params.items():
        gj = np.asarray(sj.adam.mu[k]) / np.float32(0.1)
        _close_grads(_np(st.adam.mu[k]) / np.float32(0.1), gj, k, k in MOMENT_LEAVES)
        g = _np(g)
        g = np.where(active.reshape((-1,) + (1,) * (g.ndim - 1)), g, 0.0)
        np.testing.assert_allclose(_np(st.adam.mu[k]), np.float32(0.1) * g, rtol=1e-6,
                                   atol=1e-12)
        # Parameters after the step where the gradient's sign is unambiguous.
        clear = np.abs(gj) > 1e-3 * np.abs(gj).max()
        np.testing.assert_allclose(_np(st.gmap.params[k])[clear],
                                   np.asarray(sj.gmap.params[k])[clear], atol=1e-6, err_msg=k)
        assert clear.mean() > 0.2, k
    np.testing.assert_array_equal(_np(st.gmap.denom), np.asarray(sj.gmap.denom))
    np.testing.assert_array_equal(_np(st.gmap.max_radii2d), np.asarray(sj.gmap.max_radii2d))
    acc_j = np.asarray(sj.gmap.xyz_grad_accum)
    _close_grads(_np(st.gmap.xyz_grad_accum), acc_j, "xyz_grad_accum", True)
    np.testing.assert_array_equal(_np(at.vis_filter), np.asarray(aj.vis_filter))
    np.testing.assert_array_equal(_np(at.overflow_parts), np.asarray(aj.overflow_parts))
    assert int(st.nr_iters) == int(sj.nr_iters) == 1
    fj, ft = sj.window.frames, st.window.frames
    if init:
        for f in ("R", "t", "exposure_a", "exposure_b"):
            np.testing.assert_array_equal(_np(getattr(ft, f)), np.asarray(getattr(fj, f)))
        return
    pa_j, pa_t = sj.pose_adam, st.pose_adam
    for name, moment in (("mu_rho", True), ("mu_theta", True), ("mu_ea", False),
                         ("mu_eb", False)):
        gj = np.asarray(getattr(pa_j, name))[1:] / np.float32(0.1)   # slot 0 is frame 0
        _close_grads(_np(getattr(pa_t, name))[1:] / np.float32(0.1), gj, name, moment)
        assert (np.abs(gj) > 1e-3 * np.abs(gj).max()).all(), name
    for f in ("R", "t", "exposure_a", "exposure_b"):
        np.testing.assert_allclose(_np(getattr(ft, f)), np.asarray(getattr(fj, f)), atol=1e-6,
                                   err_msg=f)
    np.testing.assert_array_equal(_np(ft.R[0]), np.asarray(js.window.frames.R[0]))


@pytest.mark.parametrize("backends", [("ref", "ref"), ("pallas", "slab")])
def test_mapping_span_trip_counts_and_exit_match_jax(backends):
    js = _state(n_live=200)
    ji, ti = JIntr(**INTR), TIntr(**INTR)
    ts = mapper_state_from_numpy(js, "cpu")
    # Disabled exit: the exact schedule (one segment of rebin_every + 4).
    _, ct = _cfgs(backends)
    st, aux = tm.mapping_span(ts, ti, ct, False, 1, 4)
    assert int(st.nr_iters) == ct.rebin_every + 4 and float(aux.loss) > 0.0
    # A huge eps stalls every iteration: the exit fires after patience
    # (+1: the first iteration cannot stall, its prev is inf).
    cj, ct = _cfgs(backends, converged_eps=10.0, converged_patience=3)
    sj, _ = jm.mapping_span(js, ji, cj, False, 2, 8)
    st, _ = tm.mapping_span(ts, ti, ct, False, 2, 8)
    assert int(st.nr_iters) == int(sj.nr_iters)
    assert 3 <= int(st.nr_iters) <= 4
    # A tiny eps never fires on an improving loss: the parity trajectory.
    _, c0 = _cfgs(backends)
    _, c1 = _cfgs(backends, converged_eps=1e-9, converged_patience=8)
    s0, a0 = tm.mapping_span(ts, ti, c0, False, 1, 2)
    s1, a1 = tm.mapping_span(ts, ti, c1, False, 1, 2)
    assert int(s0.nr_iters) == int(s1.nr_iters) == c0.rebin_every + 2
    assert torch.equal(s0.gmap.params["xyz"], s1.gmap.params["xyz"])
    assert float(a0.loss) == float(a1.loss)


def test_span_helpers_match_jax():
    for cur in (0, 7, 49, 50, 150, 2000):
        for mods in ([(150, 50), (2001, 0)], [(100, 1)], [(0, 3), (16, 10)]):
            assert tm._next_event(cur, mods) == jm._next_event(cur, mods)
    for n in range(1, 30):
        assert tm._span_args(n, 8) == jm._span_args(n, 8)
    js = _state()
    np.testing.assert_array_equal(_np(tm.window_host_pack(mapper_state_from_numpy(js, "cpu"))),
                                  np.asarray(jm.window_host_pack(js)))


def test_run_optimize_map_with_densify_matches_jax():
    """24 iterations with the cadence shrunk: densify after iteration 10 and
    the non-visible opacity reset after 20, on a map small enough that the
    densify only clones (a split draws random numbers that no two
    generators share). The densify must agree exactly (active mask). The
    parameters are held to JAX's own spread: Adam turns the sign of a
    near-zero gradient into a full lr step (and fresh moments on the clones
    make that common), so two correct float32 runs drift apart. Leaf by
    leaf, the port's largest distance to JAX's Pallas path may be at most
    twice that of JAX's own dense-oracle path (two draws of the same drift:
    within 1.1x of each other in the runs this was set from), at both
    checkpoints."""
    js = _state(seed=3)
    ls = np.random.default_rng(7).uniform(-5.5, -4.7, (C, 3)).astype(np.float32)
    js = js._replace(gmap=js.gmap._replace(params={**js.gmap.params,
                                                   "log_scales": jnp.asarray(ls)}))
    kw = dict(gaussian_update_every=16, gaussian_update_offset=10, gaussian_reset=20,
              gaussian_th=0.3)
    cj, ct = _cfgs(**kw)
    cr, _ = _cfgs(("ref", "ref"), **kw)
    ji, ti = JIntr(**INTR), TIntr(**INTR)

    def within_spread(st, sj, sr):
        np.testing.assert_array_equal(_np(st.gmap.active), np.asarray(sj.gmap.active))
        np.testing.assert_array_equal(np.asarray(sr.gmap.active), np.asarray(sj.gmap.active))
        for k in sj.gmap.params:
            a, b = _np(st.gmap.params[k]), np.asarray(sj.gmap.params[k])
            spread = np.abs(np.asarray(sr.gmap.params[k]) - b).max()
            assert np.abs(a - b).max() <= 2.0 * spread, (k, np.abs(a - b).max(), spread)

    sj, _ = jm.run_optimize_map(js, ji, cj, 10)
    sr, _ = jm.run_optimize_map(js, ji, cr, 10)
    st, _ = tm.run_optimize_map(mapper_state_from_numpy(js, "cpu"), ti, ct, 10)
    within_spread(st, sj, sr)
    assert int(np.asarray(sj.gmap.active).sum()) > NL          # the densify cloned
    sj, vis_j = jm.run_optimize_map(sj, ji, cj, 14)
    sr, _ = jm.run_optimize_map(sr, ji, cr, 14)
    st, vis_t = tm.run_optimize_map(st, ti, ct, 14)
    assert int(st.nr_iters) == int(sj.nr_iters) == 24
    within_spread(st, sj, sr)
    # Visibility thresholds float results (alpha >= 1/255, T > 1e-4): a
    # Gaussian at the edge may flip.
    assert (_np(vis_t) != np.asarray(vis_j)).mean() <= 0.005
    # The covisibility prune on the same visibility: exact.
    cj, ct = _cfgs(prune_coviz=1, **kw)
    vis = np.asarray(vis_j)
    pj, mj = jm.covisibility_prune(sj, jnp.asarray(vis), jnp.int32(0), cj)
    pt, mt = tm.covisibility_prune(st, torch.as_tensor(vis.copy()), 0, ct)
    assert 0 < int(np.asarray(mj).sum()) < int(np.asarray(sj.gmap.active).sum())
    np.testing.assert_array_equal(_np(mt), np.asarray(mj))
    np.testing.assert_array_equal(_np(pt.gmap.active), np.asarray(pj.gmap.active))
    np.testing.assert_array_equal(_np(pt.gmap.nr_obs), np.asarray(pj.gmap.nr_obs))


def test_densify_event_and_extend_event_match_jax():
    js = _state(seed=4)
    small = np.asarray(js.gmap.params["log_scales"]).copy()
    small[::2] = -5.0                                  # even rows clone, odd rows split
    js = js._replace(gmap=js.gmap._replace(params={**js.gmap.params,
                                                   "log_scales": jnp.asarray(small)}))
    cj, ct = _cfgs(gaussian_th=0.4)
    ts = mapper_state_from_numpy(js, "cpu")
    rng = np.random.default_rng(5)
    acc = rng.uniform(0, 6e-4, C).astype(np.float32)
    den = rng.integers(0, 3, C).astype(np.float32)
    js = js._replace(gmap=js.gmap._replace(xyz_grad_accum=jnp.asarray(acc),
                                           denom=jnp.asarray(den)))
    ts = ts._replace(gmap=ts.gmap._replace(xyz_grad_accum=torch.as_tensor(acc),
                                           denom=torch.as_tensor(den)))
    _, sub = jax.random.split(js.rng)
    noise = jax.random.normal(sub, (2, C, 3))
    sj, cnt_j = jm.densify_event(js, cj, init_phase=False)
    st, cnt_t = tm.densify_event(ts, ct, init_phase=False,
                                 split_noise=torch.as_tensor(np.array(noise)))
    assert [int(x) for x in cnt_t] == [int(x) for x in cnt_j]
    assert int(cnt_j[0]) > 0 and int(cnt_j[1]) > 0 and int(cnt_j[2]) > 0
    np.testing.assert_array_equal(_np(st.gmap.active), np.asarray(sj.gmap.active))
    for k in sj.gmap.params:
        np.testing.assert_allclose(_np(st.gmap.params[k]), np.asarray(sj.gmap.params[k]),
                                   rtol=1e-6, atol=1e-7, err_msg=k)

    frame_j = jcam.window_get(js.window, 1)
    frame_t = tm.Frame(*(x[1] for x in ts.window.frames))
    _, sub = jax.random.split(js.rng)
    k_scores, k_depth = jax.random.split(sub)
    ej, (na_j, nd_j) = jm.extend_event(js, frame_j, 7, JIntr(**INTR), cj, False)
    et, (na_t, nd_t) = tm.extend_event(
        ts, frame_t, 7, TIntr(**INTR), ct, False,
        scores_u=torch.as_tensor(np.array(jax.random.uniform(k_scores, (H * W,)))))
    assert (int(na_t), int(nd_t)) == (int(na_j), int(nd_j)) and int(na_j) > 0
    np.testing.assert_array_equal(_np(et.gmap.active), np.asarray(ej.gmap.active))
    np.testing.assert_array_equal(_np(et.gmap.kf_idx), np.asarray(ej.gmap.kf_idx))
    np.testing.assert_allclose(_np(et.gmap.params["xyz"]), np.asarray(ej.gmap.params["xyz"]),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(_np(et.gmap.params["log_scales"]),
                               np.asarray(ej.gmap.params["log_scales"]), rtol=1e-5, atol=1e-5)


def test_mapper_config_defaults_match_jax():
    jd = {f.name: getattr(jm.MapperConfig(), f.name)
          for f in dataclasses.fields(jm.MapperConfig)}
    td = {f.name: getattr(tm.MapperConfig(), f.name)
          for f in dataclasses.fields(tm.MapperConfig)}
    td.pop("backend")
    assert td == {k: jd[k] for k in td}


def test_run_initialize_map_matches_jax():
    """Six init iterations with densify after 1 and 4 (clones only at the
    init extent) and the opacity reset after 5: the schedule, the active
    mask and the visibility agree; after the reset every opacity logit is
    logit(0.01) moved by one Adam step (lr 0.05), so within 2 lr."""
    js = _state(seed=6)
    kw = dict(init_itr_num=6, init_gaussian_update=3, init_gaussian_reset=5)
    cj, ct = _cfgs(**kw)
    sj, vis_j = jm.run_initialize_map(js, JIntr(**INTR), cj)
    st, vis_t = tm.run_initialize_map(mapper_state_from_numpy(js, "cpu"), TIntr(**INTR), ct)
    assert int(st.nr_iters) == int(sj.nr_iters) == 6
    np.testing.assert_array_equal(_np(st.gmap.active), np.asarray(sj.gmap.active))
    assert int(np.asarray(sj.gmap.active).sum()) > NL
    assert (_np(vis_t) != np.asarray(vis_j)).mean() <= 0.005
    np.testing.assert_allclose(_np(st.gmap.params["opacity_logit"]),
                               np.asarray(sj.gmap.params["opacity_logit"]), atol=0.1 + 1e-6)
