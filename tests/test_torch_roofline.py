"""The roofline probe's plain twin and its measurement helpers on the CPU.

The JAX probe (scripts/bench_roofline.py:op_microbench) hard-codes TPU
memory spaces and has no interpret mode, so the port's twin is held
against a numpy float32 evaluation of the same chains
(scripts/bench_roofline.py:57-66): each step rounds to float32 as torch
does, so the comparison is to 1e-6 relative (exp / log1p of numpy and
torch may differ by an ulp a step, and the chains do not amplify it).
"""

import numpy as np
import pytest
import torch

from monogs_torch.ops import kernels
from monogs_torch.ops import tile_raster as tr
from monogs_torch.tools import roofline


def _numpy_chain(x, op, n_rep, lanes):
    f32 = np.float32
    accs = [(x * f32(1.0 + 0.01 * k)).astype(f32) for k in range(lanes)]
    for _ in range(n_rep):
        nxt = []
        for k, a in enumerate(accs):
            if op == "exp":
                a = np.exp(-np.abs(a)) + f32(1e-3 * (k + 1))
            elif op == "log1p":
                a = -np.log1p(-np.minimum(np.abs(a), f32(0.9))) + f32(1e-3 * (k + 1))
            elif op == "fma":
                a = a * f32(0.9995) + f32(1e-4 * (k + 1))
            else:
                a = f32(1.0) / (np.abs(a) + f32(1.0) + f32(1e-3 * (k + 1)))
            nxt.append(a.astype(f32))
        accs = nxt
    acc = accs[0]
    for a in accs[1:]:
        acc = (acc + a).astype(f32)
    return acc.max(0, keepdims=True)


@pytest.mark.parametrize("op", roofline.OPS)
@pytest.mark.parametrize("lanes", [1, 4])
def test_op_chain_twin_matches_numpy(op, lanes):
    x = roofline.probe_input((5, 16, 32), seed=3, device="cpu")
    got = roofline.op_chain_plain(x, op, 12, lanes)
    want = _numpy_chain(x.numpy(), op, 12, lanes)
    assert got.shape == (1, 16, 32)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)
    # The maximum over blocks depends on every block: pushing one block to
    # an end of the input range moves the output (one step, before the
    # log1p chain saturates at its clamp).
    base = roofline.op_chain_plain(x, op, 1, lanes)
    moved = []
    for v in (0.0, 0.95):
        y = x.clone()
        y[2] = v
        moved.append(not torch.equal(roofline.op_chain_plain(y, op, 1, lanes), base))
    assert any(moved)


def test_floors_use_the_op_mix():
    rates = {"fma": 2.0, "exp": 10.0, "log1p": 20.0, "div": 30.0}
    f = roofline.floors_ms(1_000_000, rates)
    fwd = 1e6 * (2 * 10 + 20 + 28 * 1.0) / 1e6
    bwd = 1e6 * (2 * 10 + 20 + 30 + 59 * 1.0) / 1e6
    assert f["floor_fwd_ms"] == pytest.approx(fwd)
    assert f["floor_bwd_ms"] == pytest.approx(bwd)
    assert f["floor_fwdbwd_ms"] == pytest.approx(fwd + bwd)


def test_slab_pairs_counts_the_walk():
    from monogs_torch.ops.binning import SLAB

    cfg = tr.make_raster_config(32, 32, 16)
    feats = torch.zeros((1, 16, 4 * SLAB))
    counts = torch.tensor([0, 129, 5, 300], dtype=torch.int32)
    pstart = torch.tensor([0, 0, 1, 2], dtype=torch.int32)
    p = roofline.slab_pairs(feats, pstart, counts, cfg)
    assert p["padded"] == (0 + 2 + 1 + 3) * 128 * cfg.pixels
    assert p["live"] == p["padded"]          # nothing is opaque: no tile saturates


def test_probe_launcher_takes_cuda_tensors_only():
    """No fallback: the launcher handed a CPU tensor raises and counts no
    launch; the twin (roofline.op_chain_plain) is called by name. The
    relayout launcher refuses a 4-D input before it looks at the device."""
    before = kernels.op_microbench.launches
    with pytest.raises(ValueError, match="CUDA"):
        kernels.op_microbench(torch.zeros(2, 4, 8), "exp", 4, 4)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.rows_to_channels(torch.zeros(2, 10, 16))
    with pytest.raises(ValueError, match="B, N, C"):
        kernels.rows_to_channels(torch.zeros(1, 2, 10, 16))
    assert kernels.op_microbench.launches == before
    with pytest.raises(ValueError):
        roofline.op_chain_plain(torch.zeros(1, 2, 2), "tanh", 1, 1)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="card"):
            roofline.op_microbench("exp")
        assert roofline.main() == 2
