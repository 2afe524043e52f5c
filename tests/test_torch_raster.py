"""monogs_torch's rasterizer against monogs_tpu's on the CPU.

`composite_slab` (the plain twins of the CUDA kernels, as a CPU tensor
selects) is held against JAX's Pallas kernels in interpret mode, as
tests/test_raster.py:220 runs them, and its backward against jax.vjp of
them; the feature gather, the relayout, `render` with n_touched and the
render gradients likewise. Tolerances are the JAX suite's: rgb / opacity
atol 1e-5, depth 1e-4 (test_raster.py:228-230), gradients rtol 2e-3 /
atol 1e-6 (:282), touched and n_touched exact; the float64
finite-difference check is test_raster.py:286's, on the port's slab path.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from monogs_tpu.ops import binning as jbin
from monogs_tpu.ops import projection as jproj
from monogs_tpu.ops import render as jrender
from monogs_tpu.ops import tile_raster as jtr
from monogs_tpu.ops.graphics import Intrinsics as JIntr
from monogs_torch.ops import binning as tbin
from monogs_torch.ops import kernels
from monogs_torch.ops import render as trender
from monogs_torch.ops import tile_raster as ttr
from monogs_torch.ops.graphics import Intrinsics as TIntr

torch.set_num_threads(2)   # the test workers share the CPUs (tests/test_torch_system.py)

W, H = 64, 48
TILE = 16
CAP = 256


def _t(x):
    return torch.as_tensor(np.array(x))


def _np(x):
    return x.detach().numpy() if torch.is_tensor(x) else np.asarray(x)


def _scene(n=120, seed=0, spread=0.5):
    rng = np.random.default_rng(seed)
    f32 = np.float32
    means = np.concatenate([rng.uniform(-spread, spread, (n, 2)),
                            rng.uniform(1.0, 3.0, (n, 1))], 1).astype(f32)
    scales = np.exp(rng.uniform(-3.5, -2.5, (n, 3))).astype(f32)
    quats = (rng.normal(size=(n, 4)) + [2.0, 0, 0, 0]).astype(f32)
    opac = (1.0 / (1.0 + np.exp(-rng.normal(size=n) - 0.5))).astype(f32)
    rgb = rng.uniform(size=(n, 3)).astype(f32)
    return means, scales, quats, opac, rgb


def _intr(w=W, h=H):
    kw = dict(fx=60.0, fy=60.0, cx=w / 2, cy=h / 2, width=w, height=h)
    return JIntr(**kw), TIntr(**kw)


def _pose(i):
    """A small pose offset per view index (view 0 is the identity)."""
    from monogs_tpu.ops import lie
    return (np.asarray(lie.so3_exp(jnp.asarray([0.0, 0.02 * i, 0.01 * i]))),
            np.array([0.05 * i, 0.0, 0.0], np.float32))


def _slab(n_img, seed=1):
    """JAX-built slab inputs for n_img views, in composite_slab's global
    layout (render_window's construction): numpy arrays + the config."""
    means, scales, quats, opac, rgb = _scene(seed=seed)
    ji, _ = _intr()
    cfg = jtr.make_raster_config(W, H, TILE)
    feats, pstarts, owners, firsts, counts = [], [], [], [], []
    for i in range(n_img):
        R, t = _pose(i)
        z = jnp.zeros(3)
        p = jproj.project_gaussians_ch(*map(jnp.asarray, (means, scales, quats, opac, R, t)),
                                       z, z, ji)
        opa = jnp.where(p.valid, p.opacity, 0.0)
        b = jbin.tile_bin(None, p.radius, p.depth, p.valid, img_w=W, img_h=H,
                          tile_size=TILE, tile_capacity=CAP, max_dup=4,
                          max_dup_gen=16, opacity=opa, conic=(p.ca, p.cb, p.cc),
                          uv=(p.u, p.v))
        feats.append(jtr.pack_features_slab(p.u, p.v, p.ca, p.cb, p.cc, opa,
                                            jnp.asarray(rgb), p.depth, b.gauss_of_pos,
                                            b.gsort_pos, b.gseg_start, b.g_last, 4))
        T, eb = cfg.num_tiles, feats[-1].shape[1] // jbin.SLAB
        pstarts.append(np.asarray(b.pstart_blk) + i * eb)
        owners.append(np.where(np.asarray(b.owner_blk) < T,
                               np.asarray(b.owner_blk) + i * T, n_img * T))
        firsts.append(np.asarray(b.seg_first))
        counts.append(np.asarray(b.counts))
    cat = lambda xs: np.concatenate(xs).astype(np.int32)  # noqa: E731
    return (np.stack([np.asarray(f) for f in feats]), cat(owners), cat(firsts),
            cat(pstarts), cat(counts), cfg)


def _tcfg(cfg):
    return ttr.make_raster_config(cfg.img_w, cfg.img_h, cfg.tile_size)


@pytest.mark.parametrize("emit_touched", [True, False])
@pytest.mark.parametrize("n_img", [1, 2])
def test_composite_slab_forward_matches_pallas(n_img, emit_touched):
    feats, owner, first, pstart, counts, cfg = _slab(n_img)
    oj, tj = jtr.composite_slab(jnp.asarray(feats), *map(jnp.asarray, (owner, first, pstart, counts)),
                                cfg, CAP, emit_touched)
    ot, tt = ttr.composite_slab(_t(feats), _t(pstart), _t(counts), _tcfg(cfg), CAP,
                                emit_touched)
    oj, ot = _np(oj), _np(ot)
    np.testing.assert_allclose(ot[..., [0, 1, 2, 4]], oj[..., [0, 1, 2, 4]], atol=1e-5)
    np.testing.assert_allclose(ot[..., 3], oj[..., 3], atol=1e-4)
    np.testing.assert_array_equal(ot[..., 5:], 0.0)
    np.testing.assert_array_equal(_np(tt), _np(tj))
    assert float(oj[..., 4].max()) > 0.5 and (int(_np(tj).sum()) > 0) == emit_touched


@pytest.mark.parametrize("n_img", [1, 2])
def test_composite_slab_backward_matches_pallas_vjp(n_img):
    """Per-slot gradients against Pallas at rtol 2e-3, with an absolute
    floor of 1e-4 of each channel's scale: Pallas forms d(u, v, conic) from
    pixel moments (R_x - u R_0, ...), which cancel, and lands up to ~2e-5 of
    scale off a float64 replay; the port sums per-pixel terms, and must stay
    within 1e-6 of scale of that float64 replay."""
    feats, owner, first, pstart, counts, cfg = _slab(n_img, seed=2)
    cot = np.random.default_rng(3).normal(
        size=(len(counts), cfg.pixels, 8)).astype(np.float32)
    ints = tuple(map(jnp.asarray, (owner, first, pstart, counts)))
    _, vjp = jax.vjp(lambda f: jtr.composite_slab(f, *ints, cfg, CAP, False)[0],
                     jnp.asarray(feats))
    dj, = vjp(jnp.asarray(cot))
    x = _t(feats).requires_grad_()
    out, _ = ttr.composite_slab(x, _t(pstart), _t(counts), _tcfg(cfg), CAP, False)
    dt, = torch.autograd.grad(out, x, _t(cot))
    x64 = _t(feats).double().requires_grad_()
    out64, _ = ttr.composite_slab(x64, _t(pstart), _t(counts), _tcfg(cfg), CAP, False)
    d64, = torch.autograd.grad(out64, x64, _t(cot).double())
    dt, dj, d64 = _np(dt), _np(dj), _np(d64)
    scale = np.abs(d64).max(axis=(0, 2))[None, :, None]
    bad = np.abs(dt - dj) > 1e-6 + 1e-4 * scale + 2e-3 * np.abs(dj)
    assert not bad.any(), (np.argwhere(bad), dt[bad], dj[bad])
    assert (np.abs(dt - d64) <= 1e-6 * scale + 1e-7).all()
    assert np.abs(dj[:, 10:]).max() == 0.0 and np.abs(dt[:, 10:]).max() == 0.0


def test_composite_slab_matches_dense_oracle():
    """Within the port: the slab twins against composite_tiles_ref on the
    same bins (skip rule and all), forward and backward."""
    feats, _, _, pstart, counts, cfg = _slab(1, seed=4)
    means, scales, quats, opac, rgb = _scene(seed=4)
    _, ti = _intr()
    z = torch.zeros(3)
    from monogs_torch.ops.projection import project_gaussians
    p = project_gaussians(*map(_t, (means, scales, quats, opac, rgb)), torch.eye(3), z, z, z, ti)
    opa = torch.where(p.valid, p.opacity, 0.0)
    b = tbin.tile_bin(p.mean2d, p.radius, p.depth, p.valid, img_w=W, img_h=H,
                      tile_size=TILE, tile_capacity=CAP, max_dup=4, max_dup_gen=16,
                      opacity=opa, conic=p.conic)
    dense = ttr.pack_features(p.mean2d, p.conic, opa, p.rgb, p.depth, b.index_matrix)
    o_ref, t_ref = ttr.composite_tiles_ref(dense, _tcfg(cfg))
    o_slab, t_slab = ttr.composite_slab(_t(feats), _t(pstart), _t(counts), _tcfg(cfg), CAP)
    np.testing.assert_allclose(_np(o_slab), _np(o_ref), atol=1e-5)
    np.testing.assert_array_equal(_np(t_slab), _np(t_ref))


def _pack_inputs(seed=5, n=150):
    feats_args = _scene(n=n, seed=seed)
    rng = np.random.default_rng(seed)
    ch = {k: rng.normal(size=n).astype(np.float32)
          for k in ("u", "v", "ca", "cb", "cc", "opacity", "depth")}
    ch["rgb"] = feats_args[4]
    _, ji = None, _intr()[0]
    means, scales, quats, opac, _ = feats_args
    z = jnp.zeros(3)
    p = jproj.project_gaussians_ch(*map(jnp.asarray, (means, scales, quats, opac)),
                                   jnp.eye(3), z, z, z, ji)
    b = jbin.tile_bin(None, p.radius, p.depth, p.valid, img_w=W, img_h=H,
                      tile_size=TILE, tile_capacity=CAP, max_dup=4, max_dup_gen=16,
                      opacity=jnp.where(p.valid, p.opacity, 0.0),
                      conic=(p.ca, p.cb, p.cc), uv=(p.u, p.v))
    idx = [np.asarray(x) for x in (b.gauss_of_pos, b.gsort_pos, b.gseg_start, b.g_last)]
    return ch, idx


ORDER = ("u", "v", "ca", "cb", "cc", "opacity", "rgb", "depth")


def test_pack_features_slab_forward_and_backward_match_jax():
    ch, idx = _pack_inputs()
    cot = np.random.default_rng(6).normal(size=(16, idx[0].shape[0])).astype(np.float32)
    vals = [jnp.asarray(ch[k]) for k in ORDER]
    fj, vjp = jax.vjp(lambda *a: jtr.pack_features_slab(*a, *map(jnp.asarray, idx), 4), *vals)
    gj = vjp(jnp.asarray(cot))
    leaves = [_t(ch[k]).requires_grad_() for k in ORDER]
    ft = ttr.pack_features_slab(*leaves, *map(_t, idx), 4)
    np.testing.assert_array_equal(_np(ft), _np(fj))
    gt = torch.autograd.grad(ft, leaves, _t(cot))
    for k, a, b in zip(ORDER, gj, gt):
        np.testing.assert_allclose(_np(b), _np(a), rtol=1e-6, atol=1e-6, err_msg=k)


def test_gather_pos_forward_and_backward_match_jax():
    ch, idx = _pack_inputs(seed=7)
    table = np.random.default_rng(7).normal(size=(len(ch["u"]) + 1, 16)).astype(np.float32)
    cot = np.random.default_rng(8).normal(size=(16, idx[0].shape[0])).astype(np.float32)
    fj, vjp = jax.vjp(lambda x: jtr.gather_pos(x, *map(jnp.asarray, idx), 4), jnp.asarray(table))
    x = _t(table).requires_grad_()
    ft = ttr.gather_pos(x, *map(_t, idx), 4)
    np.testing.assert_array_equal(_np(ft), _np(fj))
    np.testing.assert_allclose(_np(torch.autograd.grad(ft, x, _t(cot))[0]),
                               _np(vjp(jnp.asarray(cot))[0]), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("n", [1, 1000, 10000])
def test_rows_to_channels_matches_jax_ragged(n):
    x = np.random.default_rng(n).normal(size=(n, 16)).astype(np.float32)
    np.testing.assert_array_equal(_np(ttr.rows_to_channels(_t(x))),
                                  _np(jtr.rows_to_channels(jnp.asarray(x))))


def test_segsum_last_matches_jax():
    ch, idx = _pack_inputs(seed=9)
    dpos = np.random.default_rng(9).normal(size=(idx[0].shape[0], 16)).astype(np.float32)
    for max_dup in (1, 4, 16):
        np.testing.assert_array_equal(
            _np(ttr._segsum_last(_t(dpos), *map(_t, idx[1:]), max_dup)),
            _np(jtr._segsum_last(jnp.asarray(dpos), *map(jnp.asarray, idx[1:]), max_dup)))


def _render_both(backends, size=(W, H), bg=None, seed=1, **kw):
    means, scales, quats, opac, rgb = _scene(seed=seed)
    ji, ti = _intr(*size)
    R, t = _pose(1)
    common = dict(tile_size=TILE, tile_capacity=CAP, max_dup=4, max_dup_gen=16, **kw)
    oj = jrender.render(*map(jnp.asarray, (means, scales, quats, opac, rgb, R, t)), ji,
                        backend=backends[0], bg=None if bg is None else jnp.asarray(bg),
                        **common)
    ot = trender.render(*map(_t, (means, scales, quats, opac, rgb, R, t)), ti,
                        backend=backends[1], bg=None if bg is None else _t(bg), **common)
    return oj, ot


@pytest.mark.parametrize("size", [(W, H), (50, 30)])
@pytest.mark.parametrize("backends", [("pallas", "slab"), ("ref", "ref")])
def test_render_matches_jax(backends, size):
    bg = np.array([0.1, 0.2, 0.3], np.float32) if size != (W, H) else None
    oj, ot = _render_both(backends, size, bg=bg)
    np.testing.assert_allclose(_np(ot.rgb), _np(oj.rgb), atol=1e-5)
    np.testing.assert_allclose(_np(ot.opacity), _np(oj.opacity), atol=1e-5)
    np.testing.assert_allclose(_np(ot.depth), _np(oj.depth), atol=1e-4)
    for f in ("n_touched", "radii", "overflow", "overflow_parts"):
        np.testing.assert_array_equal(_np(getattr(ot, f)), _np(getattr(oj, f)), err_msg=f)
    assert int(_np(ot.n_touched).sum()) > 0 and ot.rgb.shape == (size[1], size[0], 3)


def test_render_without_n_touched_matches():
    oj, ot = _render_both(("pallas", "slab"), with_n_touched=False)
    np.testing.assert_allclose(_np(ot.rgb), _np(oj.rgb), atol=1e-5)
    assert int(_np(ot.n_touched).sum()) == 0


def _loss(mod, conv, backend, means, scales, quats, opac, rgb, rho, theta, **kw):
    ji, ti = _intr()
    intr = ji if mod is jrender else ti
    out = mod.render(means, scales, quats, opac, rgb, conv(np.eye(3, dtype=np.float32)),
                     conv(np.zeros(3, np.float32)), intr, rho=rho, theta=theta,
                     tile_capacity=CAP, tile_size=TILE, backend=backend, **kw)
    return ((out.rgb ** 2).mean() + 0.1 * out.depth.mean() + 0.05 * out.opacity.mean())


def test_render_gradients_match_jax():
    """Slab kernels' twins and custom backwards (gather, segmented scan,
    relayout) against JAX's Pallas path, for every render input."""
    args = (*_scene(seed=2), np.zeros(3, np.float32), np.zeros(3, np.float32))
    gj = jax.grad(lambda *a: _loss(jrender, jnp.asarray, "pallas", *a),
                  argnums=tuple(range(7)))(*map(jnp.asarray, args))
    leaves = [_t(a).requires_grad_() for a in args]
    gt = torch.autograd.grad(_loss(trender, _t, "slab", *leaves), leaves)
    names = ["means", "scales", "quats", "opac", "rgb", "rho", "theta"]
    for n, a, b in zip(names, gj, gt):
        np.testing.assert_allclose(_np(b), _np(a), rtol=2e-3, atol=1e-6, err_msg=n)


@pytest.mark.parametrize("argnum,name", [(5, "rho"), (6, "theta"), (0, "means")])
def test_gradients_finite_difference(argnum, name):
    """Float64 central differences against the port's hand-written slab
    backward (plain twins), with binning frozen at the base point. The
    scene is one whose stencil crosses no alpha threshold (the 1/255 floor
    is a step the gradient cannot see)."""
    args = [torch.as_tensor(a, dtype=torch.float64) for a in
            (*_scene(n=40, seed=4, spread=0.25), np.zeros(3), np.zeros(3))]
    _, ti = _intr()
    from monogs_torch.ops.projection import project_gaussians
    z = torch.zeros(3, dtype=torch.float64)
    p = project_gaussians(*args[:5], torch.eye(3, dtype=torch.float64), z, z, z, ti)
    bins = tbin.tile_bin(p.mean2d, p.radius, p.depth, p.valid, img_w=W, img_h=H,
                         tile_size=TILE, tile_capacity=CAP)
    f64 = lambda a: torch.as_tensor(a, dtype=torch.float64)  # noqa: E731

    def loss(*a):
        return _loss(trender, f64, "slab", *a, bins=bins)

    x0 = args[argnum].clone().requires_grad_()
    g, = torch.autograd.grad(loss(*args[:argnum], x0, *args[argnum + 1:]), x0)
    rng = np.random.RandomState(0)
    flat = x0.detach().reshape(-1)
    eps = 1e-6
    for i in rng.choice(flat.numel(), size=min(6, flat.numel()), replace=False):
        e = torch.zeros_like(flat)
        e[i] = eps
        e = e.reshape(x0.shape)
        with torch.no_grad():
            lp = loss(*args[:argnum], x0 + e, *args[argnum + 1:])
            lm = loss(*args[:argnum], x0 - e, *args[argnum + 1:])
        fd = float((lp - lm) / (2 * eps))
        np.testing.assert_allclose(float(g.reshape(-1)[i]), fd, rtol=1e-4, atol=1e-8,
                                   err_msg=f"{name}[{i}]")


def test_tile_image_roundtrip_and_matches_jax():
    rng = np.random.default_rng(10)
    for (h, w, ts) in [(48, 64, 16), (30, 50, 16), (48, 64, 32)]:
        cfg = ttr.make_raster_config(w, h, ts)
        img = rng.uniform(size=(h, w, 3)).astype(np.float32)
        tiles = trender.tile_image(_t(img), cfg)
        np.testing.assert_array_equal(
            _np(tiles), _np(jrender.tile_image(jnp.asarray(img), jtr.make_raster_config(w, h, ts))))
        np.testing.assert_array_equal(_np(trender._assemble_image(tiles, cfg)), img)
        mask = rng.uniform(size=(h, w)) > 0.5
        np.testing.assert_array_equal(
            _np(trender.tile_image(_t(mask), cfg)),
            _np(jrender.tile_image(jnp.asarray(mask), jtr.make_raster_config(w, h, ts))))


def test_kernel_launchers_take_cuda_tensors_only():
    """No fallback: a launcher handed a CPU tensor raises, and counts no
    launch; only the dispatchers in tile_raster route CPU tensors to the
    plain twins."""
    feats, _, _, pstart, counts, cfg = _slab(1)
    before = (kernels.slab_fwd.launches, kernels.slab_bwd.launches,
              kernels.rows_to_channels.launches, kernels.tile_order.launches)
    order = torch.arange(len(counts), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.slab_fwd(_t(feats), _t(pstart), _t(counts), order, _tcfg(cfg), CAP, True)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.slab_bwd(_t(feats), _t(pstart), _t(counts), order,
                         torch.zeros(len(counts), 8, cfg.pixels), _tcfg(cfg))
    with pytest.raises(ValueError, match="CUDA"):
        kernels.tile_order(_t(counts))
    with pytest.raises(ValueError, match="CUDA"):
        kernels.rows_to_channels(torch.zeros(10, 16))
    assert before == (kernels.slab_fwd.launches, kernels.slab_bwd.launches,
                      kernels.rows_to_channels.launches, kernels.tile_order.launches)
