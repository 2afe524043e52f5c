"""monogs_torch's window render against monogs_tpu's on the CPU.

`render_window` (forward, n_touched, radii, overflow; gradients of every
render input, the per-keyframe pose deltas and the (du, dv) screen-space
dummy), `pack_features_window` and its custom backward, the batched
relayout's plain twin and `measure_entry_demand`. JAX's Pallas path runs in
interpret mode, as its own suite runs it. Tolerances are the JAX suite's:
rgb / opacity 1e-5 and depth 1e-4 absolute (tests/test_raster.py:228-230),
gradients rtol 2e-3 / atol 1e-6 (:282) with the slab tests' floor of 1e-4 of the
leaf's scale for the leaves reached through the screen means and conics,
whose Pallas gradients are formed from cancelling pixel moments
(tests/test_torch_raster.py); integer outputs exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from monogs_tpu.ops import binning as jbin
from monogs_tpu.ops import lie as jlie
from monogs_tpu.ops import projection as jproj
from monogs_tpu.ops import render as jrender
from monogs_tpu.ops import tile_raster as jtr
from monogs_tpu.ops.graphics import Intrinsics as JIntr
from monogs_torch.ops import binning as tbin
from monogs_torch.ops import render as trender
from monogs_torch.ops import tile_raster as ttr
from monogs_torch.ops.graphics import Intrinsics as TIntr

W, H, TILE, CAP = 64, 48, 16, 256
WN = 3


def _t(x):
    return torch.as_tensor(np.array(x))


def _np(x):
    return x.detach().numpy() if torch.is_tensor(x) else np.asarray(x)


def _scene(n=120, seed=0):
    rng = np.random.default_rng(seed)
    f32 = np.float32
    means = np.concatenate([rng.uniform(-0.5, 0.5, (n, 2)),
                            rng.uniform(1.0, 3.0, (n, 1))], 1).astype(f32)
    scales = np.exp(rng.uniform(-3.5, -2.5, (n, 3))).astype(f32)
    quats = (rng.normal(size=(n, 4)) + [2.0, 0, 0, 0]).astype(f32)
    opac = (1.0 / (1.0 + np.exp(-rng.normal(size=n) - 0.5))).astype(f32)
    rgb = rng.uniform(size=(n, 3)).astype(f32)
    return means, scales, quats, opac, rgb


def _intr():
    kw = dict(fx=60.0, fy=60.0, cx=W / 2, cy=H / 2, width=W, height=H)
    return JIntr(**kw), TIntr(**kw)


def _poses(wn=WN):
    Rs = np.stack([np.asarray(jlie.so3_exp(jnp.asarray([0.0, 0.02 * i, 0.01 * i])))
                   for i in range(wn)]).astype(np.float32)
    ts = np.array([[0.05 * i, -0.02 * i, 0.0] for i in range(wn)], np.float32)
    return Rs, ts


KW = dict(tile_size=TILE, tile_capacity=CAP, max_dup=4, max_dup_gen=16)


def _both(backends, assemble=True, bg=None, dummy=None, seed=1, n=120):
    scene = _scene(n=n, seed=seed)
    ji, ti = _intr()
    Rs, ts = _poses()
    z = np.zeros((WN, 3), np.float32)
    oj = jrender.render_window(
        *map(jnp.asarray, (*scene, Rs, ts)), ji, rhos=jnp.asarray(z), thetas=jnp.asarray(z),
        backend=backends[0], assemble=assemble,
        bg=None if bg is None else jnp.asarray(bg),
        mean2d_dummy=None if dummy is None else jnp.asarray(dummy), **KW)
    ot = trender.render_window(
        *map(_t, (*scene, Rs, ts)), ti, rhos=_t(z), thetas=_t(z), backend=backends[1],
        assemble=assemble, bg=None if bg is None else _t(bg),
        mean2d_dummy=None if dummy is None else _t(dummy), **KW)
    return oj, ot


@pytest.mark.parametrize("backends,assemble", [(("pallas", "slab"), True),
                                               (("ref", "ref"), True),
                                               (("pallas", "slab"), False)])
def test_render_window_forward_matches_jax(backends, assemble):
    bg = None if assemble else np.array([0.1, 0.2, 0.3], np.float32)
    oj, ot = _both(backends, assemble=assemble, bg=bg)
    np.testing.assert_allclose(_np(ot.rgb), _np(oj.rgb), atol=1e-5)
    np.testing.assert_allclose(_np(ot.opacity), _np(oj.opacity), atol=1e-5)
    np.testing.assert_allclose(_np(ot.depth), _np(oj.depth), atol=1e-4)
    for f in ("n_touched", "radii", "overflow", "overflow_parts"):
        np.testing.assert_array_equal(_np(getattr(ot, f)), _np(getattr(oj, f)), err_msg=f)
    assert ot.rgb.shape == oj.rgb.shape
    assert (_np(ot.n_touched).sum(1) > 0).all()


def test_render_window_dummy_shifts_and_frozen_bins_match_jax():
    """A non-zero (Wn, N, 2) mean2d_dummy moves the projected means; frozen
    bins (the mapper's bin reuse) give the same render as JAX's."""
    n = 120
    dummy = np.random.default_rng(4).normal(scale=0.5, size=(WN, n, 2)).astype(np.float32)
    oj, ot = _both(("pallas", "slab"), dummy=dummy)
    np.testing.assert_allclose(_np(ot.rgb), _np(oj.rgb), atol=1e-5)
    np.testing.assert_array_equal(_np(ot.n_touched), _np(oj.n_touched))

    scene = _scene(n=n, seed=1)
    ji, ti = _intr()
    Rs, ts = _poses()
    z = np.zeros((WN, 3), np.float32)
    rho = np.full((WN, 3), 0.01, np.float32)
    pj = jax.vmap(lambda R, t: jproj.project_gaussians_ch(
        *map(jnp.asarray, scene[:4]), R, t, jnp.zeros(3), jnp.zeros(3), ji))(
        jnp.asarray(Rs), jnp.asarray(ts))
    bins_j = jax.vmap(lambda p: jbin.tile_bin(
        None, p.radius, p.depth, p.valid, img_w=W, img_h=H, tile_size=TILE,
        tile_capacity=CAP, max_dup=4, max_dup_gen=16,
        opacity=jnp.where(p.valid, p.opacity, 0.0), conic=(p.ca, p.cb, p.cc),
        uv=(p.u, p.v)))(pj)
    bins_t = tbin.TileBins(*(_t(x) for x in bins_j))
    oj = jrender.render_window(*map(jnp.asarray, (*scene, Rs, ts)), ji,
                               rhos=jnp.asarray(rho), thetas=jnp.asarray(z),
                               bins=bins_j, **KW)
    ot = trender.render_window(*map(_t, (*scene, Rs, ts)), ti, rhos=_t(rho),
                               thetas=_t(z), bins=bins_t, **KW)
    np.testing.assert_allclose(_np(ot.rgb), _np(oj.rgb), atol=1e-5)
    np.testing.assert_allclose(_np(ot.depth), _np(oj.depth), atol=1e-4)
    np.testing.assert_array_equal(_np(ot.n_touched), _np(oj.n_touched))


def _window_loss(mod, conv, backend, intr, Rs, ts, w, *leaves, bins=None):
    means, scales, quats, opac, rgb, rhos, thetas, du, dv = leaves
    dt = means.dtype if torch.is_tensor(means) else None
    cv = (lambda x: conv(x).to(dt)) if dt is not None else conv
    out = mod.render_window(means, scales, quats, opac, rgb, cv(Rs), cv(ts), intr,
                            rhos=rhos, thetas=thetas, backend=backend,
                            mean2d_dummy=(du, dv), bins=bins, **KW)
    return ((out.rgb * cv(w[0])).sum() + (out.depth * cv(w[1])).sum()
            + (out.opacity * cv(w[2])).sum())


# Leaves whose gradient flows through the screen means and conics, where
# the Pallas backward's pixel moments cancel (ROADMAP Queue 3).
_MOMENT_LEAVES = ("means", "scales", "quats", "rhos", "thetas", "du", "dv")


@pytest.mark.parametrize("backends", [("pallas", "slab"), ("ref", "ref")])
def test_render_window_gradients_match_jax(backends):
    """Every render input, the pose deltas and the (du, dv) dummy, against
    jax.grad (the port of tests/test_raster.py:491 across packages): rtol
    2e-3 / atol 1e-6, plus 1e-4 of the leaf's scale where the Pallas
    moments cancel. The port is also held to 1e-5 of scale against its own
    float64 replay on the same (frozen) bins."""
    n = 60
    scene = _scene(n=n, seed=2)
    ji, ti = _intr()
    Rs, ts = _poses()
    rng = np.random.default_rng(9)
    w = (rng.normal(size=(WN, H, W, 3)).astype(np.float32),
         rng.normal(size=(WN, H, W)).astype(np.float32),
         rng.normal(size=(WN, H, W)).astype(np.float32))
    z3 = np.zeros((WN, 3), np.float32)
    zn = np.zeros((WN, n), np.float32)
    args = (*scene, z3, z3, zn, zn)
    gj = jax.grad(lambda *a: _window_loss(jrender, jnp.asarray, backends[0], ji, Rs, ts, w, *a),
                  argnums=tuple(range(9)))(*map(jnp.asarray, args))
    leaves = [_t(a).requires_grad_() for a in args]
    gt = torch.autograd.grad(_window_loss(trender, _t, backends[1], ti, Rs, ts, w, *leaves),
                             leaves)
    with torch.no_grad():
        p = trender.project_window(*leaves[:4], _t(Rs), _t(ts), _t(z3), _t(z3), ti)
        bins = trender.bin_window(
            p.u, p.v, p.radius, p.depth, p.valid,
            torch.where(p.valid, p.opacity, torch.zeros_like(p.opacity)),
            (p.ca, p.cb, p.cc), ttr.make_raster_config(W, H, TILE), tile_capacity=CAP,
            max_dup=4, max_dup_gen=16, entry_capacity=None)
    l64 = [_t(a).double().requires_grad_() for a in args]
    g64 = torch.autograd.grad(_window_loss(trender, _t, backends[1], ti, Rs, ts, w, *l64,
                                           bins=bins), l64)
    names = ["means", "scales", "quats", "opac", "rgb", "rhos", "thetas", "du", "dv"]
    for name, a, b, c in zip(names, gj, gt, g64):
        a, b, c = _np(a), _np(b), _np(c)
        scale = np.abs(c).max()
        floor = 1e-4 * scale if name in _MOMENT_LEAVES else 0.0
        bad = np.abs(b - a) > 1e-6 + floor + 2e-3 * np.abs(a)
        assert not bad.any(), (name, np.argwhere(bad)[:5], a[bad][:5], b[bad][:5])
        assert np.abs(b - c).max() <= 1e-5 * scale, name
        assert scale > 0, name


def _window_bins(wn=WN, n=150, seed=5):
    scene = _scene(n=n, seed=seed)
    ji, _ = _intr()
    Rs, ts = _poses(wn)
    out = []
    for i in range(wn):
        p = jproj.project_gaussians_ch(*map(jnp.asarray, (*scene[:4], Rs[i], ts[i])),
                                       jnp.zeros(3), jnp.zeros(3), ji)
        out.append(jbin.tile_bin(None, p.radius, p.depth, p.valid, img_w=W, img_h=H,
                                 tile_size=TILE, tile_capacity=CAP, max_dup=4,
                                 max_dup_gen=16, opacity=jnp.where(p.valid, p.opacity, 0.0),
                                 conic=(p.ca, p.cb, p.cc), uv=(p.u, p.v)))
    return [np.stack([np.asarray(getattr(b, f)) for b in out])
            for f in ("gauss_of_pos", "gsort_pos", "gseg_start", "g_last")]


def test_pack_features_window_matches_jax_vjp():
    n = 150
    idx = _window_bins(n=n)
    rng = np.random.default_rng(6)
    ch = [rng.normal(size=(WN, n)).astype(np.float32) for _ in range(7)]
    rgb = [rng.uniform(size=n).astype(np.float32) for _ in range(3)]
    cot = rng.normal(size=(WN, 16, idx[0].shape[1])).astype(np.float32)
    fj, vjp = jax.vjp(lambda *a: jtr.pack_features_window(*a, *map(jnp.asarray, idx), 4),
                      *map(jnp.asarray, ch + rgb))
    gj = vjp(jnp.asarray(cot))
    leaves = [_t(x).requires_grad_() for x in ch + rgb]
    ft = ttr.pack_features_window(*leaves, *map(_t, idx), 4)
    np.testing.assert_array_equal(_np(ft), _np(fj))
    gt = torch.autograd.grad(ft, leaves, _t(cot))
    names = ["u", "v", "ca", "cb", "cc", "opacity", "depth", "r", "g", "b"]
    for name, a, b in zip(names, gj, gt):
        assert b.shape == a.shape, name
        np.testing.assert_allclose(_np(b), _np(a), rtol=1e-6, atol=1e-6, err_msg=name)
    assert float(np.abs(_np(gt[7])).max()) > 0


@pytest.mark.parametrize("shape", [(3, 1000, 16), (1, 1, 16), (8, 513, 16)])
def test_batched_relayout_twin_matches_vmapped_jax(shape):
    x = np.random.default_rng(shape[1]).normal(size=shape).astype(np.float32)
    np.testing.assert_array_equal(
        _np(ttr.rows_to_channels(_t(x))),
        _np(jax.vmap(jtr.rows_to_channels)(jnp.asarray(x))))


@pytest.mark.parametrize("max_dup,max_dup_gen", [(16, None), (4, 16)])
def test_measure_entry_demand_matches_jax_and_tile_bin(max_dup, max_dup_gen):
    scene = _scene(n=120, seed=3)
    ji, ti = _intr()
    from monogs_torch.ops.projection import project_gaussians

    pj = jproj.project_gaussians(*map(jnp.asarray, scene), jnp.eye(3), jnp.zeros(3),
                                 jnp.zeros(3), jnp.zeros(3), ji)
    opj = jnp.where(pj.valid, pj.opacity, 0.0)
    want = jbin.measure_entry_demand(pj.mean2d[:, 0], pj.mean2d[:, 1], pj.radius,
                                     pj.valid, opj, pj.conic, img_w=W, img_h=H,
                                     tile_size=TILE, tile_capacity=CAP, max_dup=max_dup,
                                     max_dup_gen=max_dup_gen)
    z = torch.zeros(3)
    pt = project_gaussians(*map(_t, scene), torch.eye(3), z, z, z, ti)
    opt = torch.where(pt.valid, pt.opacity, torch.zeros_like(pt.opacity))
    got = tbin.measure_entry_demand(pt.mean2d[:, 0], pt.mean2d[:, 1], pt.radius, pt.valid,
                                    opt, pt.conic, img_w=W, img_h=H, tile_size=TILE,
                                    tile_capacity=CAP, max_dup=max_dup,
                                    max_dup_gen=max_dup_gen)
    assert [int(x) for x in got] == [int(x) for x in want]
    bins = tbin.tile_bin(pt.mean2d, pt.radius, pt.depth, pt.valid, img_w=W, img_h=H,
                         tile_size=TILE, tile_capacity=CAP, max_dup=max_dup,
                         max_dup_gen=max_dup_gen, opacity=opt, conic=pt.conic,
                         entry_capacity=64 * tbin.SLAB)
    counts = bins.counts.numpy()
    assert int(got[1]) == counts.sum()
    assert int(got[0]) == int((-(-counts // tbin.SLAB) * tbin.SLAB).sum())
