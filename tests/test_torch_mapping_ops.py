"""monogs_torch's mapping-side helpers against monogs_tpu's on the CPU:
graphics' geometry helpers, spherical harmonics, the mapping losses (with
SSIM, PSNR and depth_reg), knn, the keyframe Window helpers and the masked
Adam. Inputs are drawn with numpy from a seed and handed to both packages.
Tolerances: exact where both compute the same float32 operations in the
same order; 1e-6 relative where the order of a sum differs (a matrix
product, a convolution, a reduction).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from monogs_tpu.models import optim as jopt
from monogs_tpu.ops import graphics as jg
from monogs_tpu.ops import losses as jl
from monogs_tpu.ops import sh as jsh
from monogs_tpu.ops.knn import knn_mean_sq_dist as jknn
from monogs_tpu.slam import camera as jcam
from monogs_torch.models import optim as topt
from monogs_torch.ops import graphics as tg
from monogs_torch.ops import losses as tl
from monogs_torch.ops import sh as tsh
from monogs_torch.ops.knn import knn_mean_sq_dist as tknn
from monogs_torch.slam import camera as tcam
from monogs_torch.utils.convert import frame_from_numpy


def _t(x):
    return torch.as_tensor(np.array(x))


def _np(x):
    return x.detach().numpy() if torch.is_tensor(x) else np.asarray(x)


RNG = np.random.default_rng(0)
R0 = np.asarray(jax.numpy.linalg.qr(jnp.asarray(RNG.normal(size=(3, 3))))[0], np.float32)
T0 = RNG.normal(size=3).astype(np.float32)


def test_graphics_helpers_match_jax():
    kw = dict(fx=50.0, fy=55.0, cx=31.0, cy=23.5, width=64, height=48)
    depth = RNG.uniform(0.5, 3.0, (48, 64)).astype(np.float32)
    pts = RNG.normal(size=(100, 3)).astype(np.float32)
    np.testing.assert_array_equal(_np(tg.world_to_view(_t(R0), _t(T0))),
                                  _np(jg.world_to_view(jnp.asarray(R0), jnp.asarray(T0))))
    np.testing.assert_allclose(_np(tg.camera_center(_t(R0), _t(T0))),
                               _np(jg.camera_center(jnp.asarray(R0), jnp.asarray(T0))),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(
        _np(tg.get_projection_matrix(0.01, 100.0, 31.0, 23.5, 50.0, 55.0, 64, 48)),
        _np(jg.get_projection_matrix(0.01, 100.0, 31.0, 23.5, 50.0, 55.0, 64, 48)),
        rtol=1e-6)
    np.testing.assert_array_equal(_np(tg.unproject(_t(depth), tg.Intrinsics(**kw))),
                                  _np(jg.unproject(jnp.asarray(depth), jg.Intrinsics(**kw))))
    for tf, jf in ((tg.transform_points, jg.transform_points),
                   (tg.cam_to_world, jg.cam_to_world)):
        np.testing.assert_allclose(_np(tf(_t(R0), _t(T0), _t(pts))),
                                   _np(jf(jnp.asarray(R0), jnp.asarray(T0), jnp.asarray(pts))),
                                   rtol=1e-6, atol=1e-6)
    back = tg.cam_to_world(_t(R0), _t(T0), tg.transform_points(_t(R0), _t(T0), _t(pts)))
    np.testing.assert_allclose(_np(back), pts, atol=1e-5)


@pytest.mark.parametrize("deg", [0, 1, 2, 3, 4])
def test_eval_sh_matches_jax(deg):
    sh = RNG.normal(size=(50, 3, (deg + 1) ** 2)).astype(np.float32)
    d = RNG.normal(size=(50, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    np.testing.assert_allclose(_np(tsh.eval_sh(deg, _t(sh), _t(d))),
                               _np(jsh.eval_sh(deg, jnp.asarray(sh), jnp.asarray(d))),
                               rtol=1e-6, atol=1e-6)


def test_sh_rgb_roundtrip_matches_jax():
    rgb = RNG.uniform(size=(20, 3)).astype(np.float32)
    np.testing.assert_array_equal(_np(tsh.rgb_to_sh(_t(rgb))), _np(jsh.rgb_to_sh(jnp.asarray(rgb))))
    np.testing.assert_allclose(_np(tsh.sh_to_rgb(tsh.rgb_to_sh(_t(rgb)))), rgb, atol=1e-6)
    with pytest.raises(ValueError):
        tsh.eval_sh(5, torch.zeros(1, 3, 36), torch.zeros(1, 3))


def _images(h=40, w=56, seed=1):
    rng = np.random.default_rng(seed)
    a = rng.uniform(size=(h, w, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(scale=0.1, size=a.shape), 0, 1).astype(np.float32)
    return a, b


@pytest.mark.parametrize("init", [False, True])
def test_get_loss_mapping_matches_jax(init):
    a, b = _images()
    rng = np.random.default_rng(2)
    d1 = rng.uniform(0.5, 3, a.shape[:2]).astype(np.float32)
    d2 = np.where(rng.uniform(size=d1.shape) > 0.2, d1 + rng.normal(scale=0.1, size=d1.shape),
                  0).astype(np.float32)
    mask = rng.uniform(size=d1.shape) > 0.1
    ea, eb = np.float32(0.05), np.float32(-0.02)
    got = tl.get_loss_mapping(*map(_t, (a, d1, b, d2, mask, ea, eb)), init=init,
                              lambda_depth=0.8)
    want = jl.get_loss_mapping(*map(jnp.asarray, (a, d1, b, d2, mask, ea, eb)), init=init,
                               lambda_depth=0.8)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


@pytest.mark.parametrize("padding", ["valid", "same"])
def test_ssim_and_l1_and_psnr_match_jax(padding):
    a, b = _images()
    np.testing.assert_allclose(float(tl.ssim(_t(a), _t(b), padding=padding)),
                               float(jl.ssim(jnp.asarray(a), jnp.asarray(b), padding=padding)),
                               rtol=1e-5)
    np.testing.assert_allclose(float(tl.ssim(_t(a), _t(a), padding=padding)), 1.0, atol=1e-5)
    np.testing.assert_allclose(float(tl.l1_loss(_t(a), _t(b))),
                               float(jl.l1_loss(jnp.asarray(a), jnp.asarray(b))), rtol=1e-6)
    np.testing.assert_allclose(float(tl.psnr(_t(a), _t(b))),
                               float(jl.psnr(jnp.asarray(a), jnp.asarray(b))), rtol=1e-6)


def test_ssim_gradient_matches_jax():
    a, b = _images(24, 30, seed=3)
    gj = jax.grad(lambda x: jl.ssim(x, jnp.asarray(b)))(jnp.asarray(a))
    x = _t(a).requires_grad_()
    gt, = torch.autograd.grad(tl.ssim(x, _t(b)), x)
    np.testing.assert_allclose(_np(gt), _np(gj), rtol=2e-3, atol=1e-7)


def test_depth_reg_matches_jax():
    a, _ = _images(seed=4)
    d = np.random.default_rng(4).uniform(0.5, 3, a.shape[:2]).astype(np.float32)
    d[:5, :7] = 0.0
    np.testing.assert_allclose(float(tl.depth_reg(_t(d), _t(a))),
                               float(jl.depth_reg(jnp.asarray(d), jnp.asarray(a))), rtol=1e-5)


@pytest.mark.parametrize("n,block", [(50, 16), (300, 1024)])
def test_knn_matches_jax_and_bruteforce(n, block):
    pts = np.random.default_rng(n).normal(size=(n, 3)).astype(np.float32)
    mask = np.random.default_rng(n + 1).uniform(size=n) > 0.2
    got = _np(tknn(_t(pts), mask=_t(mask), block=block))
    want = _np(jknn(jnp.asarray(pts), mask=jnp.asarray(mask), block=block))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)
    D = ((pts[:, None] - pts[None]) ** 2).sum(-1).astype(np.float64)
    D[:, ~mask] = np.inf
    np.fill_diagonal(D, np.inf)
    brute = np.where(mask, np.sort(D, 1)[:, :3].mean(1), 0.0)
    np.testing.assert_allclose(got, brute, rtol=1e-4, atol=1e-6)


def _frames(n=3, h=8, w=10):
    rng = np.random.default_rng(7)
    out = []
    for i in range(n):
        pose = np.eye(4, dtype=np.float32)
        pose[:3, 3] = [0.1 * i, 0, 0]
        out.append(jcam.make_frame(i, jnp.asarray(rng.uniform(size=(h, w, 3)), jnp.float32),
                                   jnp.asarray(rng.uniform(1, 2, (h, w)), jnp.float32),
                                   jnp.asarray(pose)))
    return out


def _same_window(tw, jw):
    for f in tw.frames._fields:
        np.testing.assert_array_equal(_np(getattr(tw.frames, f)),
                                      _np(getattr(jw.frames, f)), err_msg=f)
    np.testing.assert_array_equal(_np(tw.valid), _np(jw.valid))


def test_window_helpers_match_jax():
    jf = _frames()
    tf = [frame_from_numpy(f, "cpu") for f in jf]
    jw = jcam.window_from_list(jf[:2], 4)
    tw = tcam.window_from_list(tf[:2], 4)
    _same_window(tw, jw)
    assert tw.capacity == 4
    _same_window(tcam.window_set(tw, 3, tf[2]), jcam.window_set(jw, 3, jf[2]))
    _same_window(tw, jw)                        # window_set leaves its input alone
    for s in range(2):
        for a, b in zip(tcam.window_get(tw, s), jcam.window_get(jw, s)):
            np.testing.assert_array_equal(_np(a), _np(b))
    perm = np.array([0, 0, 1, 3], np.int32)
    valid = np.array([True, True, True, False])
    _same_window(tcam.window_update(tw, tf[2], _t(perm), _t(valid)),
                 jcam.window_update(jw, jf[2], jnp.asarray(perm), jnp.asarray(valid)))
    _same_window(tcam.empty_window(2, tf[0]), jcam.empty_window(2, jf[0]))
    with pytest.raises(ValueError):
        tcam.window_from_list(tf, 2)


def _params(c=40, seed=8):
    rng = np.random.default_rng(seed)
    return {"xyz": rng.normal(size=(c, 3)).astype(np.float32),
            "opacity_logit": rng.normal(size=c).astype(np.float32)}


def test_adam_step_on_identical_gradients_matches_jax():
    p = _params()
    rng = np.random.default_rng(9)
    grads = [{k: rng.normal(size=v.shape).astype(np.float32) for k, v in p.items()}
             for _ in range(3)]
    lrs = {"xyz": 0.01, "opacity_logit": 0.05}
    jp, js = {k: jnp.asarray(v) for k, v in p.items()}, None
    tp = {k: _t(v) for k, v in p.items()}
    js, ts = jopt.init_adam(jp), topt.init_adam(tp)
    for g in grads:
        jp, js = jopt.adam_step(jp, {k: jnp.asarray(v) for k, v in g.items()}, js, lrs)
        tp, ts = topt.adam_step(tp, {k: _t(v) for k, v in g.items()}, ts, lrs)
    for k in p:
        np.testing.assert_allclose(_np(tp[k]), _np(jp[k]), rtol=1e-6, atol=1e-7, err_msg=k)
        np.testing.assert_allclose(_np(ts.mu[k]), _np(js.mu[k]), rtol=1e-6, atol=1e-8)
        np.testing.assert_allclose(_np(ts.nu[k]), _np(js.nu[k]), rtol=1e-6, atol=1e-10)
    assert int(ts.step) == int(js.step) == 3
    assert topt.ADAM_EPS == jopt.ADAM_EPS == 1e-15


def test_mask_rows_zero_leaf_and_expon_lr_match_jax():
    p = _params()
    js = jopt.init_adam({k: jnp.asarray(v) + 1.0 for k, v in p.items()})
    js = js._replace(mu={k: v + 1.0 for k, v in js.mu.items()})
    ts = topt.AdamState(mu={k: _t(v) for k, v in js.mu.items()},
                        nu={k: _t(v) for k, v in js.nu.items()}, step=_t(js.step))
    rows = np.arange(40) % 3 == 0
    jm, tm = jopt.mask_rows(js, jnp.asarray(rows)), topt.mask_rows(ts, _t(rows))
    jz, tz = jopt.zero_leaf(js, "xyz"), topt.zero_leaf(ts, "xyz")
    for k in p:
        np.testing.assert_array_equal(_np(tm.mu[k]), _np(jm.mu[k]))
        np.testing.assert_array_equal(_np(tz.mu[k]), _np(jz.mu[k]))
    np.testing.assert_array_equal(_np(ts.mu["xyz"]), _np(js.mu["xyz"]))  # inputs kept
    for step in (0, 1, 500, 29999, 30000, 40000):
        for delay in (0.0, 100.0):
            want = jopt.expon_lr(jnp.asarray(step, jnp.int32), 9.6e-3, 9.6e-6, delay, 0.01,
                                 30000)
            got = topt.expon_lr(torch.tensor(step, dtype=torch.int32), 9.6e-3, 9.6e-6,
                                delay, 0.01, 30000)
            np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
