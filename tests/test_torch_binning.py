"""monogs_torch tile_bin against monogs_tpu tile_bin: every TileBins field
integer-identical, with and without max_dup_gen compaction, across the
overflow paths. Both packages bin the same numpy projection, so this file
isolates binning from projection rounding."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from monogs_tpu.ops import binning as jbin
from monogs_tpu.ops import projection as jproj
from monogs_tpu.ops.graphics import Intrinsics
from monogs_torch.ops import binning as tbin
from monogs_torch.ops import kernels

torch.set_num_threads(2)   # the test workers share the CPUs (tests/test_torch_system.py)

W, H = 64, 48


def _projection(n, seed, log_scale=(-3.5, -2.5), spread=0.6):
    """Projected channels (as numpy) of a seeded random scene."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    means = np.concatenate([rng.uniform(-spread, spread, (n, 2)),
                            rng.uniform(1.0, 3.0, (n, 1))], 1).astype(f32)
    scales = np.exp(rng.uniform(*log_scale, (n, 3))).astype(f32)
    quats = (rng.normal(size=(n, 4)) + [2.0, 0, 0, 0]).astype(f32)
    opac = (1.0 / (1.0 + np.exp(-rng.normal(size=n)))).astype(f32)
    intr = Intrinsics(fx=60.0, fy=60.0, cx=W / 2, cy=H / 2, width=W, height=H)
    z = jnp.zeros(3)
    p = jproj.project_gaussians_ch(jnp.asarray(means), jnp.asarray(scales),
                                   jnp.asarray(quats), jnp.asarray(opac),
                                   jnp.eye(3), z, z, z, intr)
    p = {k: np.array(v) for k, v in p._asdict().items()}
    p["opacity"] = np.where(p["valid"], p["opacity"], 0).astype(f32)
    return p


def _bin_both(p, cull=True, **kw):
    def call(mod, conv):
        extra = {}
        if cull:
            extra = dict(opacity=conv(p["opacity"]),
                         conic=tuple(conv(p[c]) for c in ("ca", "cb", "cc")))
        return mod.tile_bin(None, conv(p["radius"]), conv(p["depth"]),
                            conv(p["valid"]), img_w=W, img_h=H,
                            uv=(conv(p["u"]), conv(p["v"])), **extra, **kw)

    return call(jbin, jnp.asarray), call(tbin, torch.as_tensor)


def _assert_identical(bj, bt):
    for f in jbin.TileBins._fields:
        a, b = np.asarray(getattr(bj, f)), getattr(bt, f).numpy()
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(b, a, err_msg=f)


CASES = {
    # max_dup wide enough for every Gaussian, no compaction
    "plain": dict(n=120, kw=dict(tile_size=16, tile_capacity=256, max_dup=16)),
    # candidates generated 16 wide, survivors compacted to 4 (tracker default)
    "compact": dict(n=200, kw=dict(tile_size=16, tile_capacity=256, max_dup=4,
                                   max_dup_gen=16)),
    # tile 32, K 2048 (the tracker's production shape)
    "tile32": dict(n=200, kw=dict(tile_size=32, tile_capacity=2048, max_dup=4,
                                  max_dup_gen=16)),
    # slab truncated at entry_capacity: overflow_parts[3]
    "slab_overflow": dict(n=200, kw=dict(tile_size=16, tile_capacity=256,
                                         max_dup=4, max_dup_gen=16,
                                         entry_capacity=1024)),
    # dense tiles beyond tile_capacity: overflow_parts[2]
    "tile_overflow": dict(n=200, spread=0.1, kw=dict(
        tile_size=16, tile_capacity=128, max_dup=8)),
    # giant footprints beyond max_dup_gen / max_dup: overflow_parts[0], [1]
    "dup_overflow": dict(n=40, log_scale=(-1.5, -1.0), kw=dict(
        tile_size=16, tile_capacity=256, max_dup=2, max_dup_gen=4)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_tile_bin_fields_identical(case):
    c = CASES[case]
    p = _projection(c["n"], seed=len(case), spread=c.get("spread", 0.6),
                    log_scale=c.get("log_scale", (-3.5, -2.5)))
    bj, bt = _bin_both(p, **c["kw"])
    _assert_identical(bj, bt)
    parts = np.asarray(bj.overflow_parts)
    expect = {"slab_overflow": [3], "tile_overflow": [2], "dup_overflow": [0, 1]}
    for i in expect.get(case, []):
        assert parts[i] > 0, (case, parts)
    assert int(np.asarray(bj.counts).sum()) > 0
    if case == "plain":
        assert int(bj.overflow) == 0


def test_tile_bin_without_cull_identical():
    p = _projection(120, seed=11)
    bj, bt = _bin_both(p, cull=False, tile_size=16, tile_capacity=256, max_dup=16)
    _assert_identical(bj, bt)


def test_tile_bin_matrix_input_and_float_ties():
    """mean2d form, duplicated depths (the stable sort keeps entry order on
    equal keys) and zero-radius culled Gaussians."""
    p = _projection(150, seed=12)
    p["depth"][::3] = p["depth"][0]
    p["radius"][::7] = 0.0
    p["valid"][::7] = False
    mean2d = np.stack([p["u"], p["v"]], 1)
    conic = np.stack([p["ca"], p["cb"], p["cc"]], 1)
    kw = dict(img_w=W, img_h=H, tile_size=16, tile_capacity=256, max_dup=4,
              max_dup_gen=16)
    bj = jbin.tile_bin(jnp.asarray(mean2d), jnp.asarray(p["radius"]), jnp.asarray(p["depth"]),
                       jnp.asarray(p["valid"]), opacity=jnp.asarray(p["opacity"]),
                       conic=jnp.asarray(conic), **kw)
    bt = tbin.tile_bin(torch.as_tensor(mean2d), torch.as_tensor(p["radius"]),
                       torch.as_tensor(p["depth"]), torch.as_tensor(p["valid"]),
                       opacity=torch.as_tensor(p["opacity"]),
                       conic=torch.as_tensor(conic), **kw)
    _assert_identical(bj, bt)


def test_cpu_tensors_take_the_plain_twin(monkeypatch):
    """tile_bin on CPU tensors runs _tile_bin_plain and launches no kernel;
    the kernels' launcher refuses CPU tensors (tests/test_torch_bin_kernels.py
    holds the kernels to the twin on the card)."""
    calls, plain = [], tbin._tile_bin_plain
    monkeypatch.setattr(tbin, "_tile_bin_plain", lambda *a: calls.append(a) or plain(*a))
    before = kernels.tile_bin.launches
    p = {k: torch.as_tensor(v) for k, v in _projection(200, seed=5).items()}
    bins = tbin.tile_bin(None, p["radius"], p["depth"], p["valid"], img_w=W, img_h=H,
                         uv=(p["u"], p["v"]), tile_capacity=256, max_dup=8)
    assert len(calls) == 1 and int(bins.counts.sum()) > 0
    with pytest.raises(ValueError, match="CUDA"):
        kernels.tile_bin(p["u"], p["v"], p["radius"], p["depth"], p["valid"], None, None,
                         tiles_x=4, tiles_y=3, tile_size=16, K=256, max_dup=8,
                         max_dup_gen=None, P_cap=tbin.SLAB, cull_alpha=tbin.ALPHA_EPS)
    assert kernels.tile_bin.launches == before == kernels.tile_bin.by_stream.get("default", 0)


@pytest.mark.parametrize("args", [(1000, 4, 300, 2048), (50, 16, 12, 256),
                                  (100000, 4, 300, 2048)])
def test_auto_entry_capacity_matches(args):
    assert tbin.auto_entry_capacity(*args) == jbin.auto_entry_capacity(*args)


def test_constants_match():
    for name in ("CHUNK", "BLOCK_CHUNKS", "SLAB", "DEPTH_BITS", "ALPHA_EPS"):
        assert getattr(tbin, name) == getattr(jbin, name), name
