"""monogs_torch's mapper cadence against monogs_tpu's on the CPU: the
per-keyframe driver `run_optimize_map` with a densify event and the
non-visible opacity reset, the covisibility prune on its visibility, the
densify and extend events with the JAX draws fed in, and the map
initialisation driver `run_initialize_map`. Both packages start from one
state (`utils.convert.mapper_state_from_numpy`), built as
tests/test_torch_mapper.py builds it; that file holds the mapping step and
the span loop, and its tolerances hold here.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from monogs_tpu.ops.graphics import Intrinsics as JIntr
from monogs_tpu.slam import camera as jcam
from monogs_tpu.slam import mapper as jm
from monogs_torch.ops.graphics import Intrinsics as TIntr
from monogs_torch.slam import mapper as tm
from monogs_torch.utils.convert import mapper_state_from_numpy
from test_torch_mapper import C, H, INTR, NL, W, _cfgs, _np, _state

torch.set_num_threads(2)   # the test workers share the CPUs (tests/test_torch_system.py)


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
