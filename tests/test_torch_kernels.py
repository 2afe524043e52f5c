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


def _params(n=3000, seed=0, kind="plain"):
    """kind "plain": the default map; "saturating": larger Gaussians with
    opacity logits raised by 4, so most tiles saturate and the chunk vote
    skips chunks; "skewed": x and y drawn as -1 + 2 u^3, dense in one
    corner, so tile counts span well over 8x."""
    rng = np.random.default_rng(seed)
    p = {
        "xyz": np.concatenate([rng.uniform(-1.0, 1.0, (n, 2)),
                               rng.uniform(1.0, 4.0, (n, 1))], 1),
        "log_scales": rng.uniform(-4.5, -3.0, (n, 3)),
        "quats": rng.normal(size=(n, 4)) + [2.0, 0, 0, 0],
        "opacity_logit": rng.normal(size=n),
        "rgb": rng.uniform(size=(n, 3)),
    }
    if kind == "saturating":
        p["log_scales"] = p["log_scales"] + 1.25
        p["opacity_logit"] = p["opacity_logit"] + 4.0
    elif kind == "skewed":
        p["xyz"][:, :2] = -1.0 + 2.0 * rng.uniform(size=(n, 2)) ** 3
    return {k: torch.as_tensor(v, dtype=torch.float32) for k, v in p.items()}


def _slab(n_img=1, tile=TILE, kind="plain"):
    """CPU-built slab inputs for n_img views in composite_slab's global
    layout: (feats_cm, pstart_blk, counts, cfg, channels, bins)."""
    params = _params(kind=kind)
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
    order = kernels.tile_order(args[2])
    before = kernels.slab_fwd.launches
    out_k, touched_k = kernels.slab_fwd(*args, order, cfg, CAP, emit_touched)
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
    order = kernels.tile_order(args[2])
    out_k, touched_k = kernels.slab_fwd(*args, order, cfg, CAP, True)
    out_p, touched_p = tr._fwd_slab_plain(*args, cfg, CAP, True)
    _fwd_close(out_k, out_p)
    assert torch.equal(touched_k, touched_p)


@pytest.mark.parametrize("n_img", [1, 2])
def test_slab_bwd_matches_plain(cuda, n_img):
    feats, pstart, counts, cfg, _ = _slab(n_img)
    args = [x.to(cuda) for x in (feats, pstart, counts)]
    order = kernels.tile_order(args[2])
    out, _ = tr._fwd_slab_plain(*args, cfg, CAP, False)
    g = torch.randn(out.shape, generator=torch.Generator(cuda).manual_seed(1), device=cuda)
    baux = tr.bwd_aux(out, g)
    before = kernels.slab_bwd.launches
    d_k = kernels.slab_bwd(*args, order, baux, cfg)
    d_p = tr._bwd_slab_plain(*args, baux, cfg)
    torch.cuda.synchronize()
    assert kernels.slab_bwd.launches == before + 1
    _grad_close(d_k, d_p, dims=(0, 2))
    assert float(d_p.abs().max()) > 0.0 and float(d_k[:, 10:].abs().max()) == 0.0


def test_slab_bwd_is_deterministic(cuda):
    feats, pstart, counts, cfg, _ = _slab(1)
    args = [x.to(cuda) for x in (feats, pstart, counts)]
    order = kernels.tile_order(args[2])
    out, _ = tr._fwd_slab_plain(*args, cfg, CAP, False)
    baux = tr.bwd_aux(out, torch.ones_like(out))
    assert torch.equal(kernels.slab_bwd(*args, order, baux, cfg),
                       kernels.slab_bwd(*args, order, baux, cfg))


@pytest.mark.parametrize("n", [1, 511, 512, 100_000])
def test_rows_to_channels_matches_plain(cuda, n):
    x = torch.randn((n, 16), generator=torch.Generator(cuda).manual_seed(n), device=cuda)
    before = kernels.rows_to_channels.launches
    y = kernels.rows_to_channels(x)
    assert kernels.rows_to_channels.launches == before + 1
    assert torch.equal(y, tr._rows_to_channels_plain(x))


def test_composite_and_gather_autograd_on_card_match_cpu(cuda):
    """The dispatchers route a CUDA tensor to the kernels: the tile order
    (built once for both slab kernels), the slab forward, its backward and
    the relayout in pack_features_slab's backward all run on the card, and
    the gradients of every channel match the CPU twins."""
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

    path = (kernels.slab_fwd, kernels.slab_bwd, kernels.rows_to_channels, kernels.tile_order)
    before = [k.launches for k in path]
    out_c, touched_c, grads_c = run(cuda)
    after = [k.launches for k in path]
    assert [a - b for a, b in zip(after, before)] == [1, 1, 1, 1]
    out_h, touched_h, grads_h = run(torch.device("cpu"))
    _fwd_close(out_c, out_h)
    assert torch.equal(touched_c, touched_h)
    for gc, gh in zip(grads_c, grads_h):
        _grad_close(gc, gh, dims=0)


def test_slab_kernels_match_plain_at_window_8(cuda):
    """The mapping window's layout: 8 slabs, global block ids, one launch."""
    feats, pstart, counts, cfg, _ = _slab(8)
    args = [x.to(cuda) for x in (feats, pstart, counts)]
    order = kernels.tile_order(args[2])
    out_k, touched_k = kernels.slab_fwd(*args, order, cfg, CAP, True)
    out_p, touched_p = tr._fwd_slab_plain(*args, cfg, CAP, True)
    _fwd_close(out_k, out_p)
    assert torch.equal(touched_k, touched_p)
    g = torch.randn(out_p.shape, generator=torch.Generator(cuda).manual_seed(4), device=cuda)
    baux = tr.bwd_aux(out_p, g)
    _grad_close(kernels.slab_bwd(*args, order, baux, cfg), tr._bwd_slab_plain(*args, baux, cfg),
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


@pytest.mark.parametrize("tile", [16, 32])
def test_slab_fwd_variants_give_bit_identical_images(cuda, tile):
    """The touched variant computes the image exactly as the hot variant
    (the same linear T and chunk vote), as the JAX suite holds its two
    Pallas variants (tests/test_raster.py:204-217)."""
    feats, pstart, counts, cfg, _ = _slab(2, tile=tile)
    args = [x.to(cuda) for x in (feats, pstart, counts)]
    order = kernels.tile_order(args[2])
    out_hot, _ = kernels.slab_fwd(*args, order, cfg, CAP, False)
    out_touched, touched = kernels.slab_fwd(*args, order, cfg, CAP, True)
    assert torch.equal(out_hot, out_touched)
    assert int(touched.sum()) > 0


@pytest.mark.parametrize("tile", [16, 32])
def test_slab_kernels_on_a_saturating_slab(cuda, tile):
    """Opaque, larger Gaussians: the chunk vote skips chunks, and both
    kernels still match their twins (touched bit-exact)."""
    from monogs_torch.tools import roofline

    feats, pstart, counts, cfg, _ = _slab(1, tile=tile, kind="saturating")
    args = [x.to(cuda) for x in (feats, pstart, counts)]
    order = kernels.tile_order(args[2])
    nct = (args[2].to(torch.int64) + 127) // 128
    assert int(roofline.live_chunks(*args, cfg).sum()) < int(nct.sum())
    out_k, touched_k = kernels.slab_fwd(*args, order, cfg, CAP, True)
    out_p, touched_p = tr._fwd_slab_plain(*args, cfg, CAP, True)
    _fwd_close(out_k, out_p)
    assert torch.equal(touched_k, touched_p)
    g = torch.randn(out_p.shape, generator=torch.Generator(cuda).manual_seed(6), device=cuda)
    baux = tr.bwd_aux(out_p, g)
    _grad_close(kernels.slab_bwd(*args, order, baux, cfg), tr._bwd_slab_plain(*args, baux, cfg),
                dims=(0, 2))


@pytest.mark.parametrize("tile", [16, 32])
def test_slab_kernels_on_skewed_tiles(cuda, tile):
    """Tile counts spanning over 8x, so the heaviest-first order differs
    from the id order: both kernels match their twins, the tile-order
    kernel matches its twin, and the outputs do not depend on the order."""
    feats, pstart, counts, cfg, _ = _slab(2, tile=tile, kind="skewed")
    nz = counts[counts > 0]
    assert int(nz.max()) >= 8 * int(nz.min())
    args = [x.to(cuda) for x in (feats, pstart, counts)]
    before = kernels.tile_order.launches
    order = kernels.tile_order(args[2])
    assert kernels.tile_order.launches == before + 1
    assert torch.equal(order, tr._tile_order_plain(args[2]))
    assert not torch.equal(order.cpu(), torch.arange(counts.numel(), dtype=torch.int32))
    out_k, touched_k = kernels.slab_fwd(*args, order, cfg, CAP, True)
    out_p, touched_p = tr._fwd_slab_plain(*args, cfg, CAP, True)
    _fwd_close(out_k, out_p)
    assert torch.equal(touched_k, touched_p)
    g = torch.randn(out_p.shape, generator=torch.Generator(cuda).manual_seed(7), device=cuda)
    baux = tr.bwd_aux(out_p, g)
    d_k = kernels.slab_bwd(*args, order, baux, cfg)
    _grad_close(d_k, tr._bwd_slab_plain(*args, baux, cfg), dims=(0, 2))
    ids = torch.arange(counts.numel(), dtype=torch.int32, device=cuda)
    out_i, touched_i = kernels.slab_fwd(*args, ids, cfg, CAP, True)
    assert torch.equal(out_i, out_k) and torch.equal(touched_i, touched_k)
    assert torch.equal(kernels.slab_bwd(*args, ids, baux, cfg), d_k)


@pytest.mark.parametrize("kind", ["skewed", "saturating"])
@pytest.mark.parametrize("tile", [16, 32])
def test_slab_bwd_launches_are_bit_identical(cuda, tile, kind):
    """Heaviest-first scheduling keeps one block per tile and a fixed sum
    order: two launches give the same bits."""
    feats, pstart, counts, cfg, _ = _slab(2, tile=tile, kind=kind)
    args = [x.to(cuda) for x in (feats, pstart, counts)]
    order = kernels.tile_order(args[2])
    out, _ = kernels.slab_fwd(*args, order, cfg, CAP, False)
    g = torch.randn(out.shape, generator=torch.Generator(cuda).manual_seed(8), device=cuda)
    baux = tr.bwd_aux(out, g)
    assert torch.equal(kernels.slab_bwd(*args, order, baux, cfg),
                       kernels.slab_bwd(*args, order, baux, cfg))


def test_tile_order_matches_plain_at_scale(cuda):
    """Several 1024-tile rounds of the one-block counting sort, with counts
    past the 63-chunk cap and empty tiles."""
    counts = torch.randint(0, 10_000, (5000,), generator=torch.Generator().manual_seed(9),
                           dtype=torch.int32)
    counts[::7] = 0
    c = counts.to(cuda)
    assert torch.equal(kernels.tile_order(c), tr._tile_order_plain(c))


def test_slab_kernels_refuse_other_tile_sizes(cuda):
    feats, pstart, counts, _, _ = _slab(1)
    args = [x.to(cuda) for x in (feats, pstart, counts)]
    order = kernels.tile_order(args[2])
    with pytest.raises(ValueError, match="tile_size 8"):
        kernels.slab_fwd(*args, order, tr.make_raster_config(W, H, 8), CAP, False)


def test_refine_span_on_card_matches_cpu(cuda):
    """A colours-only refinement span of 8 iterations (`refine_span`: one
    binning, then the slab kernels once an iteration) on the card against
    the same span on the CPU twins, from one state with warm Adam moments:
    geometry bit-identical to the start on both, the overflow equal, and
    rgb / opacity logits by median per-Gaussian difference 1e-4 and 99th
    percentile 5e-3 (the map statistics of ROADMAP Queue 3 item 4: Adam at
    eps 1e-15 turns rounding in a near-zero gradient into a full step)."""
    from monogs_torch.models.optim import AdamState
    from monogs_torch.slam import mapper as tm
    from monogs_torch.slam.camera import make_frame, window_from_list

    n = 2000
    params = _params(n=n, seed=4)
    intr = Intrinsics(fx=110.0, fy=110.0, cx=W / 2, cy=H / 2, width=W, height=H)
    rgb = torch.rand((H, W, 3), generator=torch.Generator().manual_seed(6))
    cfg = tm.MapperConfig(tile_size=TILE, tile_capacity=CAP, max_dup=4, max_dup_gen=16)

    def run(dev):
        frame = make_frame(0, rgb, None, torch.eye(4), device=dev)
        st = tm.init_mapper_state(n, 1, window_from_list([frame], 1))
        p = {k: v.to(dev) for k, v in params.items()}
        st = st._replace(
            gmap=st.gmap._replace(params=p, active=torch.ones(n, dtype=torch.bool, device=dev)),
            adam=AdamState(mu={k: torch.full_like(v, 0.01) for k, v in p.items()},
                           nu={k: torch.full_like(v, 0.001) for k, v in p.items()},
                           step=st.adam.step))
        out, ov = tm.refine_span(st, frame, intr, cfg, 8)
        return {k: v.cpu() for k, v in out.gmap.params.items()}, int(ov)

    counted = (kernels.slab_fwd, kernels.slab_bwd, kernels.rows_to_channels)
    before = [k.launches for k in counted]
    card, ov_c = run(cuda)
    assert [k.launches - b for k, b in zip(counted, before)] == [8, 8, 8]
    plain, ov_h = run(torch.device("cpu"))
    assert ov_c == ov_h
    for k in card:
        if k in tm.REFINE_LEAVES:
            d = (card[k] - plain[k]).abs().reshape(n, -1).amax(1)
            assert float(d.median()) <= 1e-4 and float(d.quantile(0.99)) <= 5e-3, k
            assert float((card[k] - params[k]).abs().median()) > 1e-4, k
        else:
            assert torch.equal(card[k], params[k]) and torch.equal(plain[k], params[k]), k


# The chunk vote's boundary (ROADMAP Queue 3 item 3): T_SKIP is the
# kernels' float32 expf(LOG_SKIP), csrc/composite.cu.
T_SKIP = float.fromhex("0x1.a37278p-14")


def _boundary_slab(dev, tiles_x=32, tiles_y=32):
    """A slab whose tiles each end their first chunk with a transmittance
    within float32 rounding of T_SKIP, uniform over the tile's pixels: three
    slots of zero conic (alpha = opacity on every pixel), opacities 0.995
    (alpha 0.99), 0.9899 and, tile by tile, a third swept over +-1e-5
    (relative) around the value that puts (1 - 0.99)(1 - 0.9899)(1 - a) at
    T_SKIP. The second chunk holds one slot of alpha 0.5 and colour (1,
    0.5, 0.25): a tile that walks it adds ~5e-5 to its rgb, over the 1e-5
    tolerance, so a kernel whose chunk vote decides apart from the twin's
    log-space vote on any tile fails the check. -> (feats_cm, pstart_blk,
    counts, cfg)."""
    tile = 16
    cfg = tr.make_raster_config(tiles_x * tile, tiles_y * tile, tile)
    Tt = cfg.num_tiles
    f = torch.zeros((1, 16, Tt * SLAB), dtype=torch.float32)
    t = torch.arange(Tt)
    col = t * SLAB
    cu = (t % tiles_x).float() * tile + tile / 2
    cv = (t // tiles_x).float() * tile + tile / 2
    a1 = np.float32(0.9899)
    rest = float(np.float32(np.float32(1.0) - np.float32(0.99)) * (np.float32(1.0) - a1))
    a2 = 1.0 - T_SKIP / rest
    sweep = torch.linspace(a2 * (1 - 1e-5), a2 * (1 + 1e-5), Tt, dtype=torch.float64).float()
    for k, opa in ((0, torch.full((Tt,), 0.995)), (1, torch.full((Tt,), float(a1))),
                   (2, sweep), (128, torch.full((Tt,), 0.5))):
        c = col + k
        f[0, 0, c], f[0, 1, c], f[0, 5, c] = cu, cv, opa
        f[0, 6:9, c] = torch.tensor([1.0, 0.5, 0.25])[:, None] if k == 128 else 0.3
        f[0, 9, c] = 1.0 + k
    counts = torch.full((Tt,), 256, dtype=torch.int32)
    return f.to(dev), t.to(torch.int32).to(dev), counts.to(dev), cfg


def test_slab_kernels_at_the_chunk_vote_boundary(cuda):
    """Both slab kernels against their twins on tiles whose largest
    transmittance lands within rounding of T_SKIP at a chunk boundary (the
    twin walks the second chunk on some tiles and not on others)."""
    feats, pstart, counts, cfg = _boundary_slab(cuda)
    order = kernels.tile_order(counts)
    out_k, touched_k = kernels.slab_fwd(feats, pstart, counts, order, cfg, 256, True)
    out_p, touched_p = tr._fwd_slab_plain(feats, pstart, counts, cfg, 256, True)
    first, _ = tr._fwd_slab_plain(feats, pstart, torch.full_like(counts, 128), cfg, 256, False)
    walked = (out_p - first)[..., 0].abs().amax(1) > 0
    assert 0 < int(walked.sum()) < walked.numel()
    _fwd_close(out_k, out_p)
    assert torch.equal(touched_k, touched_p)
    g = torch.randn(out_p.shape, generator=torch.Generator(cuda).manual_seed(10), device=cuda)
    baux = tr.bwd_aux(out_p, g)
    _grad_close(kernels.slab_bwd(feats, pstart, counts, order, baux, cfg),
                tr._bwd_slab_plain(feats, pstart, counts, baux, cfg), dims=(0, 2))


def _smoke_slam(monkeypatch, **system):
    """A SLAM on the card from configs/synthetic/cpu_smoke.yaml with the
    slab backend (the kernels), the frame cache off."""
    import dataclasses
    import os

    from monogs_torch.data import load_dataset
    from monogs_torch.slam.system import SLAM
    from monogs_torch.utils import config as uc

    monkeypatch.chdir(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    monkeypatch.setenv("MONOGS_SYNTH_CACHE", "0")
    cfg = uc.load_config("configs/synthetic/cpu_smoke.yaml")
    slam = SLAM(load_dataset(cfg, device="cuda"),
                tracker_config=uc.build_tracker_config(cfg, backend="slab"),
                mapper_config=uc.build_mapper_config(cfg, backend="slab"),
                keyframe_config=uc.build_keyframe_config(cfg),
                system_config=dataclasses.replace(uc.build_system_config(cfg), **system),
                device="cuda")
    slam.prewarm()
    return slam


def test_run_async_with_bootstrap_equals_run_on_card(cuda, monkeypatch):
    """With every keyframe event in the bootstrap window, run_async does
    run()'s operations, the mapper's on a stream of its own: the poses
    within 1e-5 of run()'s and the active count equal; and two such runs
    give the same bits (an unordered cross-stream read would show as
    run-to-run drift). In full async mode the interleaving, and so the
    trajectory, depends on timing."""
    ref = _smoke_slam(monkeypatch)
    ref.run()
    runs = []
    for _ in range(2):
        slam = _smoke_slam(monkeypatch, async_bootstrap_kfs=99)
        kernels.reset_launches()
        slam.run_async()
        for key in ("default", kernels.stream_key(slam.mapper_stream)):
            assert kernels.slab_bwd.by_stream.get(key, 0) > 0, key
        runs.append(slam)
    for slam in runs:
        assert slam.kf_history == ref.kf_history
        assert int(slam.state.gmap.num_active) == int(ref.state.gmap.num_active)
        for i in ref.est_poses:
            for a, b in zip(slam.est_poses[i], ref.est_poses[i]):
                np.testing.assert_allclose(a, b, rtol=0, atol=1e-5)
    a, b = runs
    for i in a.est_poses:
        assert all(np.array_equal(x, y) for x, y in zip(a.est_poses[i], b.est_poses[i]))
    for k in a.state.gmap.params:
        assert torch.equal(a.state.gmap.params[k], b.state.gmap.params[k]), k


def test_run_async_on_card_tracks(cuda, monkeypatch):
    """Full async mode on the card: the tracker's (default) and the
    mapper's stream both launch the slab kernels and the relayout, and the
    run meets tests/test_async.py's bounds."""
    slam = _smoke_slam(monkeypatch)
    kernels.reset_launches()
    rmse = slam.run_async()
    mapper = kernels.stream_key(slam.mapper_stream)
    assert mapper != "default"
    for k in (kernels.slab_fwd, kernels.slab_bwd, kernels.rows_to_channels):
        assert k.by_stream.get(mapper, 0) > 0 and k.by_stream.get("default", 0) > 0
    motions = sum(np.linalg.norm(slam.gt_poses[i][1] - slam.gt_poses[i - 1][1])
                  for i in range(1, len(slam.gt_poses)))
    assert np.isfinite(rmse) and rmse < 2.0 * motions
    assert int(slam.state.gmap.num_active) > 50
