"""The hand-written Hopper kernels against their plain PyTorch twins, on the
card, at small sizes. Every test is marked `gpu` and skips where no card
is found; the check runs inside the `cuda` fixture, never at import, so
every pytest worker collects the same tests.

This file imports neither JAX nor the JAX package, so it runs on a machine
with the card and no JAX:

    python -m pytest --noconftest -m gpu tests/test_torch_kernels.py -q

Tolerances are the JAX suite's (tests/test_raster.py:228-230, :282):
forward rgb / alpha 1e-5 and depth 1e-4 absolute, gradients rtol 2e-3 /
atol 1e-6 plus a floor for the order of the per-slot pixel sums
(`_grad_close`); `touched` and the relayout bit-exact; the roofline probe
1e-5 of its largest value.
"""

import numpy as np
import pytest
import torch

from monogs_torch.models.gaussian_map import get_opacity, get_scales
from monogs_torch.ops import kernels, lie
from monogs_torch.ops import tile_raster as tr
from monogs_torch.ops.binning import SLAB, tile_bin
from monogs_torch.ops.graphics import Intrinsics
from monogs_torch.ops.projection import project_gaussians_ch

pytestmark = pytest.mark.gpu

W, H, TILE, CAP = 128, 96, 16, 512


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernels have no CPU mode")
    return torch.device("cuda")


def _params(n=3000, seed=0):
    rng = np.random.default_rng(seed)
    p = {
        "xyz": np.concatenate([rng.uniform(-1.0, 1.0, (n, 2)),
                               rng.uniform(1.0, 4.0, (n, 1))], 1),
        "log_scales": rng.uniform(-4.5, -3.0, (n, 3)),
        "quats": rng.normal(size=(n, 4)) + [2.0, 0, 0, 0],
        "opacity_logit": rng.normal(size=n),
        "rgb": rng.uniform(size=(n, 3)),
    }
    return {k: torch.as_tensor(v, dtype=torch.float32) for k, v in p.items()}


def _slab(n_img=1, tile=TILE):
    """CPU-built slab inputs for n_img views in composite_slab's global
    layout: (feats_cm, pstart_blk, counts, cfg, channels, bins)."""
    params = _params()
    intr = Intrinsics(fx=110.0, fy=110.0, cx=W / 2, cy=H / 2, width=W, height=H)
    cfg = tr.make_raster_config(W, H, tile)
    z = torch.zeros(3)
    feats, pstarts, counts, views = [], [], [], []
    for i in range(n_img):
        R, t = lie.apply_pose_delta(torch.eye(3), z, torch.tensor([0.02 * i, 0, 0]),
                                    torch.tensor([0, 0.01 * i, 0]))
        p = project_gaussians_ch(params["xyz"], get_scales(params, False),
                                 params["quats"], get_opacity(params), R, t, z, z, intr)
        opa = torch.where(p.valid, p.opacity, torch.zeros_like(p.opacity))
        b = tile_bin(None, p.radius, p.depth, p.valid, img_w=W, img_h=H,
                     tile_size=tile, tile_capacity=CAP, max_dup=4, max_dup_gen=16,
                     opacity=opa, conic=(p.ca, p.cb, p.cc), uv=(p.u, p.v))
        ch = (p.u, p.v, p.ca, p.cb, p.cc, opa, params["rgb"], p.depth)
        feats.append(tr.pack_features_slab(*ch, b.gauss_of_pos, b.gsort_pos,
                                           b.gseg_start, b.g_last, 4).detach())
        pstarts.append(b.pstart_blk + i * (feats[-1].shape[1] // SLAB))
        counts.append(b.counts)
        views.append((ch, b))
    return (torch.stack(feats), torch.cat(pstarts), torch.cat(counts), cfg, views)


def _grad_close(a, b, dims):
    """The per-slot sums over a tile's pixels run in another order on the
    card, so on top of the JAX suite's rtol 2e-3 / atol 1e-6 each value
    may miss by 1e-4 of its channel's largest magnitude (the bound that
    test_torch_raster.py holds the Pallas backward to)."""
    a, b = a.cpu(), b.cpu()
    scale = b.abs().amax(dim=dims, keepdim=True)
    bad = (a - b).abs() > 1e-6 + 2e-3 * b.abs() + 1e-4 * scale
    assert not bad.any(), (bad.nonzero()[:10], a[bad][:10], b[bad][:10])


def _fwd_close(a, b):
    a, b = a.cpu(), b.cpu()
    torch.testing.assert_close(a[..., [0, 1, 2, 4]], b[..., [0, 1, 2, 4]], atol=1e-5, rtol=0)
    torch.testing.assert_close(a[..., 3], b[..., 3], atol=1e-4, rtol=0)


@pytest.mark.parametrize("emit_touched", [True, False])
@pytest.mark.parametrize("n_img", [1, 2])
def test_slab_fwd_matches_plain(cuda, n_img, emit_touched):
    feats, pstart, counts, cfg, _ = _slab(n_img)
    args = [x.to(cuda) for x in (feats, pstart, counts)]
    before = kernels.slab_fwd.launches
    out_k, touched_k = kernels.slab_fwd(*args, cfg, CAP, emit_touched)
    out_p, touched_p = tr._fwd_slab_plain(*args, cfg, CAP, emit_touched)
    torch.cuda.synchronize()
    assert kernels.slab_fwd.launches == before + 1
    _fwd_close(out_k, out_p)
    assert torch.equal(touched_k, touched_p)
    assert float(out_p[..., 4].max()) > 0.5 and (int(touched_p.sum()) > 0) == emit_touched


@pytest.mark.parametrize("tile", [16, 32])
def test_slab_fwd_matches_plain_per_tile_size(cuda, tile):
    feats, pstart, counts, cfg, _ = _slab(1, tile=tile)
    args = [x.to(cuda) for x in (feats, pstart, counts)]
    out_k, touched_k = kernels.slab_fwd(*args, cfg, CAP, True)
    out_p, touched_p = tr._fwd_slab_plain(*args, cfg, CAP, True)
    _fwd_close(out_k, out_p)
    assert torch.equal(touched_k, touched_p)


@pytest.mark.parametrize("n_img", [1, 2])
def test_slab_bwd_matches_plain(cuda, n_img):
    feats, pstart, counts, cfg, _ = _slab(n_img)
    args = [x.to(cuda) for x in (feats, pstart, counts)]
    out, _ = tr._fwd_slab_plain(*args, cfg, CAP, False)
    g = torch.randn(out.shape, generator=torch.Generator(cuda).manual_seed(1), device=cuda)
    baux = tr.bwd_aux(out, g)
    before = kernels.slab_bwd.launches
    d_k = kernels.slab_bwd(*args, baux, cfg)
    d_p = tr._bwd_slab_plain(*args, baux, cfg)
    torch.cuda.synchronize()
    assert kernels.slab_bwd.launches == before + 1
    _grad_close(d_k, d_p, dims=(0, 2))
    assert float(d_p.abs().max()) > 0.0 and float(d_k[:, 10:].abs().max()) == 0.0


def test_slab_bwd_is_deterministic(cuda):
    feats, pstart, counts, cfg, _ = _slab(1)
    args = [x.to(cuda) for x in (feats, pstart, counts)]
    out, _ = tr._fwd_slab_plain(*args, cfg, CAP, False)
    baux = tr.bwd_aux(out, torch.ones_like(out))
    assert torch.equal(kernels.slab_bwd(*args, baux, cfg), kernels.slab_bwd(*args, baux, cfg))


@pytest.mark.parametrize("n", [1, 511, 512, 100_000])
def test_rows_to_channels_matches_plain(cuda, n):
    x = torch.randn((n, 16), generator=torch.Generator(cuda).manual_seed(n), device=cuda)
    before = kernels.rows_to_channels.launches
    y = kernels.rows_to_channels(x)
    assert kernels.rows_to_channels.launches == before + 1
    assert torch.equal(y, tr._rows_to_channels_plain(x))


def test_composite_and_gather_autograd_on_card_match_cpu(cuda):
    """The dispatchers route a CUDA tensor to the kernels: the slab forward,
    its backward and the relayout in pack_features_slab's backward all run
    on the card, and the gradients of every channel match the CPU twins."""
    _, _, _, cfg, views = _slab(1)
    ch, b = views[0]
    idx = (b.gauss_of_pos, b.gsort_pos, b.gseg_start, b.g_last)
    cot = torch.randn((cfg.num_tiles, cfg.pixels, 8), generator=torch.Generator().manual_seed(2))

    def run(dev):
        leaves = [c.detach().to(dev).requires_grad_() for c in ch]
        feats = tr.pack_features_slab(*leaves, *(i.to(dev) for i in idx), 4)
        out, touched = tr.composite_slab(feats[None], b.pstart_blk.to(dev),
                                         b.counts.to(dev), cfg, CAP, True)
        grads = torch.autograd.grad(out, leaves, cot.to(dev))
        return out.detach().cpu(), touched.cpu(), [g.cpu() for g in grads]

    before = [k.launches for k in (kernels.slab_fwd, kernels.slab_bwd, kernels.rows_to_channels)]
    out_c, touched_c, grads_c = run(cuda)
    after = [k.launches for k in (kernels.slab_fwd, kernels.slab_bwd, kernels.rows_to_channels)]
    assert [a - b for a, b in zip(after, before)] == [1, 1, 1]
    out_h, touched_h, grads_h = run(torch.device("cpu"))
    _fwd_close(out_c, out_h)
    assert torch.equal(touched_c, touched_h)
    for gc, gh in zip(grads_c, grads_h):
        _grad_close(gc, gh, dims=0)


def test_slab_kernels_match_plain_at_window_8(cuda):
    """The mapping window's layout: 8 slabs, global block ids, one launch."""
    feats, pstart, counts, cfg, _ = _slab(8)
    args = [x.to(cuda) for x in (feats, pstart, counts)]
    out_k, touched_k = kernels.slab_fwd(*args, cfg, CAP, True)
    out_p, touched_p = tr._fwd_slab_plain(*args, cfg, CAP, True)
    _fwd_close(out_k, out_p)
    assert torch.equal(touched_k, touched_p)
    g = torch.randn(out_p.shape, generator=torch.Generator(cuda).manual_seed(4), device=cuda)
    baux = tr.bwd_aux(out_p, g)
    _grad_close(kernels.slab_bwd(*args, baux, cfg), tr._bwd_slab_plain(*args, baux, cfg),
                dims=(0, 2))


@pytest.mark.parametrize("shape", [(8, 131_072, 16), (3, 1001, 16), (1, 1, 16)])
def test_rows_to_channels_batched_matches_plain(cuda, shape):
    x = torch.randn(shape, generator=torch.Generator(cuda).manual_seed(shape[1]), device=cuda)
    before = kernels.rows_to_channels.launches
    y = kernels.rows_to_channels(x)
    assert kernels.rows_to_channels.launches == before + 1
    assert torch.equal(y, tr._rows_to_channels_plain(x))


@pytest.mark.parametrize("op", ["fma", "exp", "log1p", "div"])
def test_op_microbench_matches_plain(cuda, op):
    """The probe against its twin: rounding may differ by an ulp a step
    between expf / log1pf and torch's, so 1e-5 of the largest value."""
    from monogs_torch.tools import roofline

    x = roofline.probe_input((16, 1024, 128), seed=1, device=cuda)
    before = kernels.op_microbench.launches
    k = kernels.op_microbench(x, op, 16, 4)
    p = roofline.op_chain_plain(x, op, 16, 4)
    assert kernels.op_microbench.launches == before + 1
    assert float((k - p).abs().max()) <= 1e-5 * float(p.abs().max())


def test_window_render_on_card_matches_cpu(cuda):
    """render_window's gradients on the card (slab kernels and the batched
    relayout, one launch each) against the CPU twins."""
    from monogs_torch.ops.render import render_window

    params = _params(n=2000, seed=3)
    intr = Intrinsics(fx=110.0, fy=110.0, cx=W / 2, cy=H / 2, width=W, height=H)
    Rs = torch.eye(3).repeat(3, 1, 1)
    ts = torch.tensor([[0.0, 0, 0], [0.02, 0, 0], [0.0, 0.02, 0]])
    w = torch.randn((3, H, W, 3), generator=torch.Generator().manual_seed(5))

    def run(dev):
        leaves = [params[k].to(dev).requires_grad_() for k in
                  ("xyz", "log_scales", "quats", "opacity_logit", "rgb")]
        z = torch.zeros((3, 3), device=dev)
        out = render_window(leaves[0], torch.exp(leaves[1]), leaves[2],
                            torch.sigmoid(leaves[3]), leaves[4], Rs.to(dev), ts.to(dev),
                            intr, rhos=z, thetas=z, tile_size=TILE, tile_capacity=CAP,
                            max_dup=4, max_dup_gen=16)
        grads = torch.autograd.grad((out.rgb * w.to(dev)).sum(), leaves)
        return out.rgb.detach().cpu(), out.n_touched.cpu(), [g.cpu() for g in grads]

    before = [k.launches for k in (kernels.slab_fwd, kernels.slab_bwd, kernels.rows_to_channels)]
    rgb_c, nt_c, g_c = run(cuda)
    after = [k.launches for k in (kernels.slab_fwd, kernels.slab_bwd, kernels.rows_to_channels)]
    assert [a - b for a, b in zip(after, before)] == [1, 1, 1]
    rgb_h, nt_h, g_h = run(torch.device("cpu"))
    torch.testing.assert_close(rgb_c, rgb_h, atol=1e-5, rtol=0)
    assert torch.equal(nt_c, nt_h)
    for gc, gh in zip(g_c, g_h):
        _grad_close(gc, gh, dims=0)
