"""monogs_torch's Gaussian map against monogs_tpu's on the CPU (the port of
tests/test_map_model.py across packages).

Extend, densify (clone and split), prune, the opacity resets, the
densification statistics and growth, each on the same map in both
packages. The JAX functions draw from a key; the test draws the same
numbers with jax.random from the same key and feeds them to the port
(`scores_u`, `depth_noise`, `split_noise`), so slot allocation, the active
mask, counts and every integer field must match exactly. Float fields
match to 1e-6 relative (the knn distances' matrix product sums in another
order) and exactly where both packages run the same float32 operations.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from monogs_tpu.models import gaussian_map as jgm
from monogs_tpu.models.optim import init_adam as jinit_adam
from monogs_tpu.ops.graphics import Intrinsics as JIntr
from monogs_torch.models import gaussian_map as tgm
from monogs_torch.models.optim import AdamState
from monogs_torch.ops.graphics import Intrinsics as TIntr

torch.set_num_threads(2)   # the test workers share the CPUs (tests/test_torch_system.py)

CAP = 256
H, W = 24, 32
INTR = dict(fx=30.0, fy=30.0, cx=W / 2, cy=H / 2, width=W, height=H)


def _t(x):
    return torch.as_tensor(np.array(x))


def _np(x):
    return x.detach().numpy() if torch.is_tensor(x) else np.asarray(x)


def _jmap(n_active=32, seed=0, big=False):
    gmap = jgm.init_map(CAP, nr_objects=2)
    rng = np.random.default_rng(seed)
    params = dict(gmap.params)
    params["xyz"] = jnp.asarray(rng.normal(size=(CAP, 3)), jnp.float32)
    params["opacity_logit"] = jnp.asarray(rng.normal(size=CAP) + 0.5, jnp.float32)
    ls = rng.uniform(-5.5, -4.0, (CAP, 3))
    if big:          # odd rows large (split), even rows small (clone)
        ls[1::2] = rng.uniform(-3.0, -1.5, (CAP // 2, 3))
    params["log_scales"] = jnp.asarray(ls, jnp.float32)
    params["quats"] = jnp.asarray(rng.normal(size=(CAP, 4)) + [2.0, 0, 0, 0], jnp.float32)
    params["rgb"] = jnp.asarray(rng.uniform(size=(CAP, 3)), jnp.float32)
    active = jnp.arange(CAP) < n_active
    gmap = gmap._replace(
        params=params, active=active,
        kf_idx=jnp.asarray(rng.integers(0, 5, CAP), jnp.int32),
        nr_obs=jnp.asarray(rng.integers(0, 4, CAP), jnp.int32),
        obj_prob=jnp.asarray(rng.uniform(size=(CAP, 2)), jnp.float32),
        max_radii2d=jnp.asarray(rng.uniform(0, 30, CAP), jnp.float32),
        xyz_grad_accum=jnp.asarray(rng.uniform(0, 4e-3, CAP), jnp.float32),
        denom=jnp.asarray(rng.integers(0, 5, CAP), jnp.float32))
    adam = jinit_adam(params)
    adam = adam._replace(mu=jax.tree.map(lambda x: x + 0.1, adam.mu),
                         nu=jax.tree.map(lambda x: x + 0.2, adam.nu))
    return gmap, adam


def _tmap(gmap, adam):
    g = tgm.GaussianMap(params={k: _t(v) for k, v in gmap.params.items()},
                        **{f: _t(getattr(gmap, f)) for f in tgm.GaussianMap._fields
                           if f != "params"})
    a = AdamState(mu={k: _t(v) for k, v in adam.mu.items()},
                  nu={k: _t(v) for k, v in adam.nu.items()}, step=_t(adam.step))
    return g, a


def _same(tmap, tadam, jmap, jadam, rtol=0.0, atol=0.0):
    for f in jgm.GaussianMap._fields:
        if f == "params":
            continue
        a, b = _np(getattr(tmap, f)), _np(getattr(jmap, f))
        if a.dtype.kind in "biu":
            np.testing.assert_array_equal(a, b, err_msg=f)
        else:
            np.testing.assert_allclose(a, b, rtol=rtol, atol=atol, err_msg=f)
    for k in jmap.params:
        np.testing.assert_allclose(_np(tmap.params[k]), _np(jmap.params[k]), rtol=rtol,
                                   atol=atol, err_msg=k)
        np.testing.assert_allclose(_np(tadam.mu[k]), _np(jadam.mu[k]), rtol=rtol,
                                   atol=atol, err_msg=k)
        np.testing.assert_allclose(_np(tadam.nu[k]), _np(jadam.nu[k]), rtol=rtol,
                                   atol=atol, err_msg=k)


def _keyframe(seed=1, holes=False):
    rng = np.random.default_rng(seed)
    depth = rng.uniform(1.5, 2.5, (H, W)).astype(np.float32)
    if holes:
        depth[rng.uniform(size=(H, W)) < 0.3] = 0.0
    rgb = rng.uniform(size=(H, W, 3)).astype(np.float32)
    seg = rng.integers(0, 3, (H, W)).astype(np.int32)
    rdepth = (depth + rng.normal(scale=0.3, size=(H, W))).astype(np.float32)
    ropa = rng.uniform(size=(H, W)).astype(np.float32)
    return rgb, depth, seg, rdepth, ropa


@pytest.mark.parametrize("init,monocular,holes,n_active", [
    (True, False, False, 8), (False, False, True, 32), (False, True, False, 32),
    (False, False, False, CAP - 20)])
def test_extend_from_keyframe_matches_jax(init, monocular, holes, n_active):
    jmap, jadam = _jmap(n_active=n_active)
    tmap, tadam = _tmap(jmap, jadam)
    rgb, depth, seg, rdepth, ropa = _keyframe(holes=holes)
    key = jax.random.PRNGKey(3)
    k_scores, k_depth = jax.random.split(key)
    scores_u = jax.random.uniform(k_scores, (H * W,))
    depth_noise = jax.random.normal(k_depth, (H, W))
    R = np.asarray(jax.numpy.linalg.qr(jnp.asarray(
        np.random.default_rng(2).normal(size=(3, 3))))[0], np.float32)
    t = np.array([0.1, -0.2, 0.3], np.float32)
    kw = dict(kf_idx=4, init=init, monocular=monocular, fill_depth_dropout=holes,
              downsample_init=8, downsample=4, max_new=96)
    extra = {} if init else dict(render_depth=rdepth, render_opacity=ropa)
    jres = jgm.extend_from_keyframe(
        jmap, jadam, key, rgb=jnp.asarray(rgb), depth=jnp.asarray(depth),
        segmentation=jnp.asarray(seg), R_w2c=jnp.asarray(R), t_w2c=jnp.asarray(t),
        intr=JIntr(**INTR), exposure_a=jnp.float32(0.1), exposure_b=jnp.float32(-0.05),
        **{k: jnp.asarray(v) for k, v in extra.items()}, **kw)
    tres = tgm.extend_from_keyframe(
        tmap, tadam, rgb=_t(rgb), depth=_t(depth), segmentation=_t(seg), R_w2c=_t(R),
        t_w2c=_t(t), intr=TIntr(**INTR), exposure_a=torch.tensor(0.1),
        exposure_b=torch.tensor(-0.05), **{k: _t(v) for k, v in extra.items()},
        scores_u=_t(scores_u), depth_noise=_t(depth_noise), **kw)
    assert int(tres.n_added) == int(jres.n_added) > 0
    assert int(tres.n_dropped) == int(jres.n_dropped)
    _same(tres.map, tres.adam, jres.map, jres.adam, rtol=1e-5, atol=1e-6)
    if n_active > CAP - 96:
        assert int(tres.n_dropped) > 0


@pytest.mark.parametrize("max_screen", [None, 20.0])
def test_densify_and_prune_matches_jax(max_screen):
    jmap, jadam = _jmap(n_active=64, big=True)
    tmap, tadam = _tmap(jmap, jadam)
    key = jax.random.PRNGKey(5)
    noise = jax.random.normal(key, (2, CAP, 3))
    kw = dict(max_grad=2e-4, min_opacity=0.3, extent=1.0, max_screen_size=max_screen,
              percent_dense=0.01)
    jout = jgm.densify_and_prune(jmap, jadam, key, **kw)
    tout = tgm.densify_and_prune(tmap, tadam, split_noise=_t(noise), **kw)
    counts = [int(x) for x in jout[2:]]
    assert [int(x) for x in tout[2:]] == counts
    assert counts[0] > 0 and counts[1] > 0 and counts[2] > 0, counts
    _same(tout[0], tout[1], jout[0], jout[1], rtol=1e-6, atol=1e-7)


def test_prune_resets_and_stats_match_jax():
    jmap, jadam = _jmap(n_active=100)
    tmap, tadam = _tmap(jmap, jadam)
    rng = np.random.default_rng(11)
    mask = rng.uniform(size=CAP) < 0.3
    visible = rng.uniform(size=CAP) < 0.5
    radii = rng.uniform(0, 40, CAP).astype(np.float32)
    g2d = rng.normal(scale=1e-3, size=(CAP, 2)).astype(np.float32)
    cases = [
        (lambda g, a, cv: tgm.prune_points(g, a, cv(mask)),
         lambda g, a, cv: jgm.prune_points(g, a, cv(mask))),
        (lambda g, a, cv: tgm.reset_opacity(g, a), lambda g, a, cv: jgm.reset_opacity(g, a)),
        (lambda g, a, cv: tgm.reset_opacity_nonvisible(g, a, cv(visible)),
         lambda g, a, cv: jgm.reset_opacity_nonvisible(g, a, cv(visible))),
        (lambda g, a, cv: (tgm.increment_nr_obs(g, cv(visible)), a),
         lambda g, a, cv: (jgm.increment_nr_obs(g, cv(visible)), a)),
        (lambda g, a, cv: (tgm.update_max_radii(g, cv(radii), cv(visible)), a),
         lambda g, a, cv: (jgm.update_max_radii(g, cv(radii), cv(visible)), a)),
        (lambda g, a, cv: (tgm.add_densification_stats(g, cv(g2d), cv(visible), W, H), a),
         lambda g, a, cv: (jgm.add_densification_stats(g, cv(g2d), cv(visible), W, H), a)),
    ]
    for tf, jf in cases:
        tg_, ta = tf(tmap, tadam, _t)
        jg_, ja = jf(jmap, jadam, jnp.asarray)
        _same(tg_, ta, jg_, ja, rtol=1e-6, atol=1e-9)
    assert tgm.inverse_sigmoid(0.01) == float(jgm.inverse_sigmoid(0.01))


def test_grow_and_alloc_slots_match_jax():
    jmap, jadam = _jmap(n_active=40)
    tmap, tadam = _tmap(jmap, jadam)
    jg_, ja = jgm.grow(jmap, jadam, CAP + 64)
    tg_, ta = tgm.grow(tmap, tadam, CAP + 64)
    _same(tg_, ta, jg_, ja)
    assert tg_.capacity == CAP + 64
    with pytest.raises(ValueError):
        tgm.grow(tmap, tadam, CAP - 1)
    rng = np.random.default_rng(12)
    active = rng.uniform(size=CAP) < 0.9
    want = rng.uniform(size=CAP) < 0.2
    jd, jok, jdrop = jgm._alloc_slots(jnp.asarray(active), jnp.asarray(want))
    td, tok, tdrop = tgm._alloc_slots(_t(active), _t(want))
    np.testing.assert_array_equal(_np(td), _np(jd))
    np.testing.assert_array_equal(_np(tok), _np(jok))
    assert int(tdrop) == int(jdrop) > 0


@pytest.mark.parametrize("init", [True, False])
def test_extend_event_seeds_obj_prob_matches_jax(init):
    """The mapper's extend event on a keyframe with a segmentation (object
    ids 0-2 on a two-object map, so id 2 clamps to 1), from one state in
    both packages with JAX's draws fed to the port: the seeded Gaussians'
    obj_prob one-hots, the active mask and the creating keyframe agree
    exactly (init: seeding only; after init: the render's densification
    mask first)."""
    from monogs_tpu.slam import camera as jcam
    from monogs_tpu.slam import mapper as jm
    from monogs_torch.slam import mapper as tm
    from monogs_torch.utils.convert import mapper_state_from_numpy

    rgb, depth, seg, _, _ = _keyframe(seed=3)
    pose = np.eye(4, dtype=np.float32)
    pose[:3, 3] = [0.05, -0.02, 0.1]
    frame = jcam.make_frame(1, jnp.asarray(rgb), jnp.asarray(depth), jnp.asarray(pose),
                            segmentation=jnp.asarray(seg))
    js = jm.init_mapper_state(CAP, 2, jcam.window_from_list([frame], 2))
    if not init:
        jmap, jadam = _jmap(n_active=40)
        js = js._replace(gmap=jmap._replace(obj_prob=jnp.zeros((CAP, 2), jnp.float32)),
                         adam=jadam)
    ts = mapper_state_from_numpy(js, "cpu")
    kw = dict(tile_size=16, tile_capacity=256, pcd_downsample_init=8, pcd_downsample=4,
              max_new_per_kf=96)
    _, sub = jax.random.split(js.rng)
    k_scores, k_depth = jax.random.split(sub)
    jout, (na_j, _) = jm.extend_event(js, frame, 1, JIntr(**INTR),
                                      jm.MapperConfig(backend="ref", **kw), init)
    tframe = tm.Frame(*(x[0] for x in ts.window.frames))
    tout, (na_t, _) = tm.extend_event(
        ts, tframe, 1, TIntr(**INTR), tm.MapperConfig(backend="ref", **kw), init,
        scores_u=_t(jax.random.uniform(k_scores, (H * W,))),
        depth_noise=_t(jax.random.normal(k_depth, (H, W))))
    assert int(na_t) == int(na_j) > 0
    for f in ("active", "kf_idx", "obj_prob"):
        np.testing.assert_array_equal(_np(getattr(tout.gmap, f)),
                                      np.asarray(getattr(jout.gmap, f)), err_msg=f)
    new = np.asarray(jout.gmap.active) & ~np.asarray(js.gmap.active)
    onehot = np.asarray(jout.gmap.obj_prob)[new]
    assert (onehot.sum(1) == 1).all() and onehot[:, 1].any() and onehot[:, 0].any()
