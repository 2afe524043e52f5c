"""Parity of monogs_torch's foundations with monogs_tpu on the CPU: lie,
projection, losses, make_frame, and the port's import rule.

Inputs are drawn with numpy from a seed and handed to both packages.
Tolerances are the JAX suite's: values to float32 rounding, gradients at
rtol 2e-3 / atol 1e-6 (tests/test_raster.py:282), masks exact.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from monogs_tpu.ops import lie as jlie
from monogs_tpu.ops import losses as jloss
from monogs_tpu.ops import projection as jproj
from monogs_tpu.ops.graphics import Intrinsics as JIntr
from monogs_tpu.slam import camera as jcam
from monogs_torch.ops import lie as tlie
from monogs_torch.ops import losses as tloss
from monogs_torch.ops import projection as tproj
from monogs_torch.ops.graphics import Intrinsics as TIntr
from monogs_torch.slam import camera as tcam

torch.set_num_threads(2)   # the test workers share the CPUs (tests/test_torch_system.py)

W, H = 64, 48
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _t(x):
    return torch.as_tensor(np.array(x))


def _np(x):
    return x.detach().numpy() if torch.is_tensor(x) else np.asarray(x)


def _rotvecs(seed=0):
    """Rotation vectors across both _sinc_coeffs branches."""
    rng = np.random.default_rng(seed)
    dirs = rng.normal(size=(6, 3))
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    mags = np.array([0.0, 1e-5, 3e-3, 0.02, 0.7, 2.5])
    return (dirs * mags[:, None]).astype(np.float32)


@pytest.mark.parametrize("name", ["skew", "so3_exp", "so3_left_jacobian",
                                  "so3_log", "se3_exp", "quat_to_rotmat"])
def test_lie_values_match_jax(name):
    rng = np.random.default_rng(1)
    for v in _rotvecs():
        if name == "se3_exp":
            x = np.concatenate([rng.normal(size=3).astype(np.float32), v])
        elif name == "so3_log":
            x = np.asarray(jlie.so3_exp(jnp.asarray(v)))
        elif name == "quat_to_rotmat":
            x = rng.normal(size=(5, 4)).astype(np.float32)
        else:
            x = v
        a = getattr(jlie, name)(jnp.asarray(x))
        b = getattr(tlie, name)(_t(x))
        np.testing.assert_allclose(_np(b), _np(a), rtol=1e-6, atol=2e-6,
                                   err_msg=f"{name} at |v|={np.linalg.norm(v)}")


def test_apply_pose_delta_and_gradient_match_jax():
    rng = np.random.default_rng(2)
    R = np.asarray(jlie.so3_exp(jnp.asarray(_rotvecs()[4])))
    t = rng.normal(size=3).astype(np.float32)
    w = rng.normal(size=(3, 4)).astype(np.float32)

    def jf(rho, theta):
        Rn, tn = jlie.apply_pose_delta(jnp.asarray(R), jnp.asarray(t), rho, theta)
        return jnp.sum(jnp.concatenate([Rn, tn[:, None]], 1) * w)

    z = np.zeros(3, np.float32)
    gj = jax.grad(jf, argnums=(0, 1))(jnp.asarray(z), jnp.asarray(z))
    leaves = [_t(z).requires_grad_(), _t(z).requires_grad_()]
    Rn, tn = tlie.apply_pose_delta(_t(R), _t(t), *leaves)
    gt = torch.autograd.grad((torch.cat([Rn, tn[:, None]], 1) * _t(w)).sum(), leaves)
    for a, b in zip(gj, gt):
        np.testing.assert_allclose(_np(b), _np(a), rtol=1e-5, atol=1e-6)


def test_pose_chain_keeps_det_one():
    """Hundreds of retractions keep det(R) = 1 (the JAX package's bf16
    drift reached 1.54); the port's 3x3 products are elementwise sums that
    never reach a tensor core, and the chain tracks the JAX one."""
    rng = np.random.default_rng(3)
    Rj, tj = jnp.eye(3), jnp.zeros(3)
    Rt, tt = torch.eye(3), torch.zeros(3)
    for _ in range(300):
        rho = (0.01 * rng.normal(size=3)).astype(np.float32)
        theta = (0.02 * rng.normal(size=3)).astype(np.float32)
        Rj, tj = jlie.apply_pose_delta(Rj, tj, jnp.asarray(rho), jnp.asarray(theta))
        Rt, tt = tlie.apply_pose_delta(Rt, tt, _t(rho), _t(theta))
    assert abs(float(torch.linalg.det(Rt.double())) - 1.0) < 1e-5
    np.testing.assert_allclose(_np(Rt), _np(Rj), atol=1e-5)
    np.testing.assert_allclose(_np(tt), _np(tj), atol=1e-5)


def _gaussians(n=60, seed=0):
    rng = np.random.default_rng(seed)
    means = np.concatenate([rng.uniform(-0.8, 0.8, (n, 2)),
                            rng.uniform(0.1, 3.0, (n, 1))], 1)  # some near-culled
    scales = np.exp(rng.uniform(-3.5, -2.0, (n, 3)))
    quats = rng.normal(size=(n, 4)) + np.array([2.0, 0, 0, 0])
    opac = 1.0 / (1.0 + np.exp(-rng.normal(size=n) * 3))
    active = rng.uniform(size=n) > 0.1
    pose = np.asarray(jlie.so3_exp(jnp.asarray([0.05, -0.03, 0.02]))), \
        np.array([0.02, -0.01, 0.05])
    f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
    return tuple(map(f32, (means, scales, quats, opac))), active, tuple(map(f32, pose))


def _intr():
    return (JIntr(fx=60.0, fy=62.0, cx=W / 2, cy=H / 2, width=W, height=H),
            TIntr(fx=60.0, fy=62.0, cx=W / 2, cy=H / 2, width=W, height=H))


def test_project_gaussians_ch_values_match_jax():
    (means, scales, quats, opac), active, (R, t) = _gaussians()
    ji, ti = _intr()
    z = np.zeros(3, np.float32)
    pj = jproj.project_gaussians_ch(*map(jnp.asarray, (means, scales, quats, opac, R, t, z, z)),
                                    ji, active=jnp.asarray(active))
    pt = tproj.project_gaussians_ch(*map(_t, (means, scales, quats, opac, R, t, z, z)),
                                    ti, active=_t(active))
    for f in ("radius", "valid", "opacity"):
        np.testing.assert_array_equal(_np(getattr(pt, f)), _np(getattr(pj, f)), err_msg=f)
    for f in ("u", "v", "depth", "ca", "cb", "cc"):
        np.testing.assert_allclose(_np(getattr(pt, f)), _np(getattr(pj, f)),
                                   rtol=2e-6, atol=2e-6, err_msg=f)
    assert 0 < int(pj.valid.sum()) < len(opac)   # both cull branches taken
    mj = jproj.project_gaussians(*map(jnp.asarray, (means, scales, quats, opac, opac[:, None].repeat(3, 1), R, t, z, z)), ji)
    mt = tproj.project_gaussians(*map(_t, (means, scales, quats, opac, opac[:, None].repeat(3, 1), R, t, z, z)), ti)
    np.testing.assert_allclose(_np(mt.conic), _np(mj.conic), rtol=2e-6, atol=2e-6)
    np.testing.assert_allclose(_np(mt.mean2d), _np(mj.mean2d), rtol=2e-6, atol=2e-6)


def test_build_cov3d_matches_jax():
    (_, scales, quats, _), _, _ = _gaussians()
    np.testing.assert_allclose(
        _np(tproj.build_cov3d(_t(scales), _t(quats))),
        _np(jproj.build_cov3d(jnp.asarray(scales), jnp.asarray(quats))),
        rtol=1e-5, atol=1e-9)


@pytest.mark.parametrize("wrt", ["means", "rho", "theta"])
def test_project_gaussians_ch_gradients_match_jax(wrt):
    (means, scales, quats, opac), active, (R, t) = _gaussians(seed=4)
    ji, ti = _intr()
    rng = np.random.default_rng(5)
    chans = ("u", "v", "ca", "cb", "cc", "depth")
    wts = {c: rng.normal(size=len(opac)).astype(np.float32) for c in chans}
    z = np.zeros(3, np.float32)
    inputs = {"means": means, "rho": z, "theta": z}

    def jf(x):
        kw = dict(inputs, **{wrt: x})
        p = jproj.project_gaussians_ch(jnp.asarray(kw["means"]), *map(jnp.asarray, (scales, quats, opac, R, t)),
                                       jnp.asarray(kw["rho"]), jnp.asarray(kw["theta"]), ji)
        return sum(jnp.sum(jnp.where(p.valid, getattr(p, c), 0.0) * wts[c]) for c in chans)

    gj = jax.grad(jf)(jnp.asarray(inputs[wrt]))
    leaf = _t(inputs[wrt]).clone().requires_grad_()
    kw = {k: _t(v) for k, v in inputs.items()}
    kw[wrt] = leaf
    p = tproj.project_gaussians_ch(kw["means"], *map(_t, (scales, quats, opac, R, t)),
                                   kw["rho"], kw["theta"], ti)
    s = sum((torch.where(p.valid, getattr(p, c), 0.0) * _t(wts[c])).sum() for c in chans)
    gt, = torch.autograd.grad(s, leaf)
    np.testing.assert_allclose(_np(gt), _np(gj), rtol=2e-3, atol=1e-6)


def _image(seed=6, h=H, w=W):
    rng = np.random.default_rng(seed)
    base = rng.uniform(size=(h // 4, w // 4, 3))
    img = np.kron(base, np.ones((4, 4, 1))) + 0.05 * rng.normal(size=(h, w, 3))
    return np.clip(img, 0, 1).astype(np.float32)


def test_image_gradient_and_masks_match_jax():
    img = _image()
    gray = img.mean(-1)
    gray[5:9, 10:20] = 0.0                       # invalid pixels for the mask
    for a, b in zip(jloss.image_gradient(jnp.asarray(gray)), tloss.image_gradient(_t(gray))):
        np.testing.assert_allclose(_np(b), _np(a), atol=1e-6)
    for a, b in zip(jloss.image_gradient_mask(jnp.asarray(gray)),
                    tloss.image_gradient_mask(_t(gray))):
        np.testing.assert_array_equal(_np(b), _np(a))


@pytest.mark.parametrize("seed", [6, 7])
def test_compute_grad_mask_matches_jax(seed):
    img = _image(seed)
    np.testing.assert_array_equal(_np(tloss.compute_grad_mask(_t(img))),
                                  _np(jloss.compute_grad_mask(jnp.asarray(img))))


def test_median_depth_averages_middle_values_like_jax():
    """torch.median returns the lower middle value; jnp.(nan)median average
    the two. An even count of valid depths tells them apart."""
    depth = np.array([[0.0, 1.0, 2.0], [4.0, 0.0, 8.0]], np.float32)   # 4 valid
    mask = np.array([[True, True, True], [True, True, True]])
    a = jloss.get_median_depth(jnp.asarray(depth), jnp.asarray(mask))
    b = tloss.get_median_depth(_t(depth), _t(mask))
    assert float(a) == float(b) == 3.0
    assert float(torch.median(_t(depth)[_t(depth) > 0])) == 2.0    # the trap
    odd = np.array([[0.5, 0.0, 2.0], [4.0, 0.0, 8.0]], np.float32)
    assert float(tloss.get_median_depth(_t(odd))) == float(jloss.get_median_depth(jnp.asarray(odd)))
    none = np.zeros((2, 3), np.float32)
    assert np.isnan(float(tloss.get_median_depth(_t(none))))
    assert np.isnan(float(jloss.get_median_depth(jnp.asarray(none))))
    rnd = np.random.default_rng(8).uniform(0, 3, (H, W)).astype(np.float32)
    assert float(tloss.get_median_depth(_t(rnd))) == float(jloss.get_median_depth(jnp.asarray(rnd)))


@pytest.mark.parametrize("tiled", [False, True])
def test_loss_tracking_value_and_gradients_match_jax(tiled):
    rng = np.random.default_rng(9)
    f32 = np.float32
    r_rgb, g_rgb = rng.uniform(size=(2, H, W, 3)).astype(f32)
    r_dep = rng.uniform(0.5, 3.0, (H, W)).astype(f32)
    g_dep = np.where(rng.uniform(size=(H, W)) > 0.2, rng.uniform(0.5, 3.0, (H, W)), 0).astype(f32)
    r_opa = rng.uniform(size=(H, W)).astype(f32)
    mask = rng.uniform(size=(H, W)) > 0.3
    gmask = rng.uniform(size=(H, W)) > 0.4
    ea, eb = f32(0.1), f32(-0.05)
    kw = dict(opacity_threshold=0.5, rgb_npix=H * W if tiled else None)
    diff = (r_rgb, r_dep, r_opa, ea, eb)

    def jf(r, d, o, a, b):
        return jloss.get_loss_tracking(r, d, o, jnp.asarray(g_rgb), jnp.asarray(g_dep),
                                       jnp.asarray(mask), jnp.asarray(gmask), a, b, **kw)

    lj = jf(*map(jnp.asarray, diff))
    gj = jax.grad(jf, argnums=tuple(range(5)))(*map(jnp.asarray, diff))
    leaves = [_t(x).requires_grad_() for x in diff]
    lt = tloss.get_loss_tracking(*leaves[:3], _t(g_rgb), _t(g_dep), _t(mask), _t(gmask),
                                 *leaves[3:], **kw)
    gt = torch.autograd.grad(lt, leaves)
    np.testing.assert_allclose(float(lt.detach()), float(lj), rtol=1e-6)
    for a, b in zip(gj, gt):
        np.testing.assert_allclose(_np(b), _np(a), rtol=2e-3, atol=1e-6)


def test_make_frame_matches_jax():
    rng = np.random.default_rng(10)
    rgb = _image(11)
    depth = rng.uniform(0.5, 3.0, (H, W)).astype(np.float32)
    mask = rng.uniform(size=(H, W)) > 0.1
    pose = np.eye(4, dtype=np.float32)
    pose[:3, :3] = np.asarray(jlie.so3_exp(jnp.asarray([0.1, 0.2, -0.1])))
    pose[:3, 3] = [0.3, -0.2, 0.1]
    fj = jcam.make_frame(3, jnp.asarray(rgb), jnp.asarray(depth), jnp.asarray(pose),
                         mask=jnp.asarray(mask))
    ft = tcam.make_frame(3, rgb, depth, pose, mask=mask, device="cpu")
    for f in tcam.Frame._fields:
        a, b = _np(getattr(fj, f)), _np(getattr(ft, f))
        assert a.dtype == b.dtype and a.shape == b.shape, f
        np.testing.assert_array_equal(b, a, err_msg=f)
    moved = tcam.with_pose(ft, torch.eye(3), torch.ones(3))
    assert float(moved.t.sum()) == 3.0 and moved.R_gt is ft.R_gt


def test_port_imports_neither_jax_nor_the_jax_package():
    code = (
        "import importlib, pkgutil, sys\n"
        "import monogs_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(monogs_torch.__path__, 'monogs_torch.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'monogs_tpu')]\n"
        "assert len(names) >= 12, names\n"
        "assert not bad, bad\n"
        "print(len(names))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
