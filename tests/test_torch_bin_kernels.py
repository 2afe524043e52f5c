"""The tile-binning kernels (csrc/binning.cu) against their plain PyTorch
twin, on the card: every TileBins field equal with torch.equal, the twin
run on the same CUDA tensors. Every test is marked `gpu` and skips where no
card is found (the check runs inside the `cuda` fixture, never at import).

This file imports neither JAX nor the JAX package:

    python -m pytest --noconftest -m gpu tests/test_torch_bin_kernels.py -q
"""

import threading

import numpy as np
import pytest
import torch

from monogs_torch.ops import binning, kernels
from monogs_torch.ops.binning import SLAB, TileBins
from monogs_torch.ops.graphics import Intrinsics
from monogs_torch.tools.roofline import room_projection

pytestmark = pytest.mark.gpu

# The benchmark's room at 320x240 (slambench/configs/room-rgbd-320.yaml).
ROOM = Intrinsics(fx=267.7, fy=269.6, cx=159.8, cy=123.55, width=320, height=240)
ROOM_ROWS = 32_768
CELL = dict(tile_capacity=16_384, max_dup=300, max_dup_gen=300, entry_capacity=1_310_720)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernels have no CPU mode")
    return torch.device("cuda")


def _channels(n, seed, w, h, dev, centre=None, spread=1.0, sigma=(0.5, 6.0)):
    """Random screen-space channels (u, v, ca, cb, cc, depth, radius,
    opacity, valid) of n Gaussians drawn with numpy: means over the image
    (or within `spread` pixels of `centre`), covariances R diag(s^2) R^T
    with s in `sigma` pixels, a 3-sigma radius, 10% invalid."""
    rng = np.random.default_rng(seed)
    if centre is None:
        uv = rng.uniform([-20, -20], [w + 20, h + 20], (n, 2))
    else:
        uv = np.asarray(centre) + rng.uniform(-spread, spread, (n, 2))
    s = rng.uniform(*sigma, (n, 2))
    a = rng.uniform(0, np.pi, n)
    c, si = np.cos(a), np.sin(a)
    sxx = c * c * s[:, 0] ** 2 + si * si * s[:, 1] ** 2
    syy = si * si * s[:, 0] ** 2 + c * c * s[:, 1] ** 2
    sxy = c * si * (s[:, 0] ** 2 - s[:, 1] ** 2)
    det = sxx * syy - sxy ** 2
    ch = dict(u=uv[:, 0], v=uv[:, 1], ca=syy / det, cb=-sxy / det, cc=sxx / det,
              depth=rng.uniform(0.3, 6.0, n), radius=np.ceil(3 * s.max(1)),
              opacity=rng.uniform(0.0, 1.0, n))
    out = {k: torch.as_tensor(x, dtype=torch.float32, device=dev) for k, x in ch.items()}
    out["valid"] = torch.as_tensor(rng.uniform(size=n) > 0.1, device=dev)
    out["opacity"] = torch.where(out["valid"], out["opacity"], 0.0)
    return out


def _room(dev, frame=40):
    p = room_projection(ROOM_ROWS, frame, ROOM, dev)
    return {k: getattr(p, k) for k in p._fields}


def _bin(ch, w, h, cull=True, **kw):
    """tile_bin's dispatch on CUDA tensors (the kernels) and the plain twin
    on the same tensors."""
    extra = dict(opacity=ch["opacity"], conic=(ch["ca"], ch["cb"], ch["cc"])) if cull else {}
    args = (None, ch["radius"], ch["depth"], ch["valid"])
    before = kernels.tile_bin.launches
    got = binning.tile_bin(*args, img_w=w, img_h=h, uv=(ch["u"], ch["v"]), **extra, **kw)
    assert kernels.tile_bin.launches == before + 1
    ts = kw.get("tile_size", 16)
    tx, ty = -(-w // ts), -(-h // ts)
    cap = kw.get("entry_capacity") or binning.auto_entry_capacity(
        ch["u"].shape[0], kw["max_dup"], tx * ty, kw["tile_capacity"])
    want = binning._tile_bin_plain(
        ch["u"], ch["v"], ch["radius"], ch["depth"], ch["valid"], extra.get("opacity"),
        extra.get("conic"), tx, ty, ts, kw["tile_capacity"], kw["max_dup"],
        kw.get("max_dup_gen"), cap, binning.ALPHA_EPS)
    return got, want


def _assert_equal(got: TileBins, want: TileBins):
    torch.cuda.synchronize()
    for f in TileBins._fields:
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype and a.shape == b.shape, f
        assert torch.equal(a, b), (f, (a != b).nonzero()[:8].tolist())


def test_room_at_the_cells_shapes(cuda):
    """The cells' tracking binning: tile 32, max_dup 300, N 32,768 at a room
    pose, nothing dropped."""
    got, want = _bin(_room(cuda), 320, 240, tile_size=32, **CELL)
    _assert_equal(got, want)
    assert int(want.counts.sum()) > 1000 and int(want.overflow) == 0


@pytest.mark.parametrize("frame", [0, 120])
def test_room_at_tile_16(cuda, frame):
    """The keyframe extend's binning: tile 16, T = 300."""
    got, want = _bin(_room(cuda, frame), 320, 240, tile_size=16, **CELL)
    _assert_equal(got, want)
    assert want.counts.shape == (300,) and int(want.counts.sum()) > 0


CASES = {
    # rows truncated: D_gen 16 > max_dup 4 (overflow_parts[1]) and
    # coverage past D_gen (overflow_parts[0])
    "d_gen_over_max_dup": dict(n=5000, sigma=(2.0, 30.0), kw=dict(
        tile_size=16, tile_capacity=2048, max_dup=4, max_dup_gen=16)),
    # tiles past K (overflow_parts[2])
    "tile_over_k": dict(n=20_000, kw=dict(tile_size=32, tile_capacity=256, max_dup=16)),
    # the slab truncated at P_cap (overflow_parts[3])
    "p_cap_truncation": dict(n=20_000, kw=dict(
        tile_size=16, tile_capacity=1024, max_dup=8, entry_capacity=40 * SLAB)),
    # N not a multiple of the 256-thread blocks
    "ragged_n": dict(n=4099, kw=dict(tile_size=16, tile_capacity=1024, max_dup=16)),
    # N below one block
    "tiny_n": dict(n=7, kw=dict(tile_size=32, tile_capacity=128, max_dup=8)),
    # a tile size that is not a power of two: the rectangle's division
    "tile_24": dict(n=8000, kw=dict(tile_size=24, tile_capacity=2048, max_dup=16)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_kernels_equal_the_twin(cuda, case):
    c = CASES[case]
    ch = _channels(c["n"], 11, 320, 240, cuda, sigma=c.get("sigma", (0.5, 6.0)))
    got, want = _bin(ch, 320, 240, **c["kw"])
    _assert_equal(got, want)


def test_overflow_parts_all_nonzero(cuda):
    """Every cap bites at once: each overflow part is exercised."""
    ch = _channels(20_000, 12, 320, 240, cuda, sigma=(2.0, 40.0))
    got, want = _bin(ch, 320, 240, tile_size=16, tile_capacity=256, max_dup=4,
                     max_dup_gen=8, entry_capacity=60 * SLAB)
    _assert_equal(got, want)
    assert bool((want.overflow_parts > 0).all()), want.overflow_parts.tolist()


def test_bucket_past_the_shared_memory_sort(cuda):
    """One tile holds 40,000 entries, past the 12,288 keys the sort keeps
    in shared memory: the global-memory sort."""
    ch = _channels(40_000, 13, 320, 240, cuda, centre=(80.0, 80.0), spread=6.0,
                   sigma=(0.3, 1.5))
    got, want = _bin(ch, 320, 240, tile_size=32, tile_capacity=16_384, max_dup=4,
                     entry_capacity=1_310_720)
    _assert_equal(got, want)
    assert int(want.overflow_parts[2]) > 0


def test_depth_ties_across_gaussians(cuda):
    """Depths on a coarse grid: thousands of Gaussians share their top 20
    depth bits in a tile, so the order within a tile is the Gaussian index."""
    ch = _channels(20_000, 14, 320, 240, cuda)
    ch["depth"] = torch.round(ch["depth"] * 2) / 2
    got, want = _bin(ch, 320, 240, tile_size=32, tile_capacity=4096, max_dup=16)
    _assert_equal(got, want)


def test_no_valid_gaussian(cuda):
    ch = _channels(3000, 15, 320, 240, cuda)
    ch["valid"] = torch.zeros_like(ch["valid"])
    got, want = _bin(ch, 320, 240, tile_size=16, tile_capacity=512, max_dup=8)
    _assert_equal(got, want)
    assert int(want.counts.sum()) == 0


def test_without_the_cull(cuda):
    ch = _channels(5000, 16, 320, 240, cuda)
    got, want = _bin(ch, 320, 240, cull=False, tile_size=16, tile_capacity=2048,
                     max_dup=12, max_dup_gen=20)
    _assert_equal(got, want)


def test_launches_give_identical_bins(cuda):
    """The scatter's atomics take another order each launch; the bins may
    not: five launches on one input, bit for bit."""
    ch = _room(cuda)
    runs = [binning.tile_bin(None, ch["radius"], ch["depth"], ch["valid"], img_w=320,
                             img_h=240, tile_size=16, opacity=ch["opacity"],
                             conic=(ch["ca"], ch["cb"], ch["cc"]), uv=(ch["u"], ch["v"]),
                             **CELL) for _ in range(5)]
    for r in runs[1:]:
        _assert_equal(r, runs[0])


def test_two_streams_at_once(cuda):
    """Two threads bin at once, each on a stream of its own, as run_async's
    tracker and mapper do: each gets the single-stream result."""
    inputs = [_room(cuda, 20), _room(cuda, 90)]

    def call(ch):
        return binning.tile_bin(None, ch["radius"], ch["depth"], ch["valid"], img_w=320,
                                img_h=240, tile_size=32, opacity=ch["opacity"],
                                conic=(ch["ca"], ch["cb"], ch["cc"]), uv=(ch["u"], ch["v"]),
                                **CELL)

    want = [call(ch) for ch in inputs]
    torch.cuda.synchronize()
    got, errors = [[None] * 4 for _ in inputs], []
    barrier = threading.Barrier(2)

    def worker(j):
        try:
            with torch.cuda.stream(torch.cuda.Stream()):
                barrier.wait(timeout=30)
                for r in range(4):
                    got[j][r] = call(inputs[j])
                torch.cuda.current_stream().synchronize()
        except Exception as e:  # reported below, with the thread's index
            errors.append((j, repr(e)))

    threads = [threading.Thread(target=worker, args=(j,)) for j in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads) and not errors, errors
    for j in range(2):
        for r in range(4):
            _assert_equal(got[j][r], want[j])


def test_launcher_refuses_what_it_cannot_take(cuda):
    ch = _channels(100, 17, 64, 48, cuda)
    kw = dict(tiles_x=4, tiles_y=3, tile_size=16, K=128, max_dup=4, max_dup_gen=None,
              P_cap=SLAB, cull_alpha=binning.ALPHA_EPS)
    conic = (ch["ca"], ch["cb"], ch["cc"])
    good = [ch["u"], ch["v"], ch["radius"], ch["depth"], ch["valid"], ch["opacity"], conic]
    before = kernels.tile_bin.launches
    bad_dtype = list(good)
    bad_dtype[3] = ch["depth"].double()
    strided = torch.stack([ch["u"], ch["v"]], 1)
    bad_stride = list(good)
    bad_stride[0] = strided[:, 0]
    for args in (bad_dtype, bad_stride):
        with pytest.raises(ValueError, match="contiguous"):
            kernels.tile_bin(*args, **kw)
    # Through tile_bin: a strided channel is made contiguous, a float64 one
    # is refused.
    with pytest.raises(ValueError, match="float32"):
        binning.tile_bin(None, ch["radius"], ch["depth"].double(), ch["valid"], img_w=64,
                         img_h=48, tile_capacity=128, max_dup=4, uv=(ch["u"], ch["v"]))
    assert kernels.tile_bin.launches == before
    got = binning.tile_bin(strided, ch["radius"], ch["depth"], ch["valid"], img_w=64, img_h=48,
                           tile_capacity=128, max_dup=4)
    want = binning._tile_bin_plain(ch["u"], ch["v"], ch["radius"], ch["depth"], ch["valid"],
                                   None, None, 4, 3, 16, 128, 4, None, got.gsort_pos.shape[0],
                                   binning.ALPHA_EPS)
    _assert_equal(got, want)
