"""The port's CPU plain twins give the same bits on their first call in a
process as on every later call.

In a fresh process the first multi-threaded float32 `torch.exp` could return
wrong values on one worker thread's chunk (relative errors up to 1.5e-4,
torch 2.13.0+cpu with 8 intra-op threads): the slab forward twin's first
call then missed the JAX reference by 5e-5 against a 1e-5 tolerance, in
about one process of three. `tile_raster.warm_cpu_math` runs once at the
first CPU `_alpha` (shared by the slab twins and the dense oracle) and
removes it. This test runs the twins and the oracle in many fresh
processes, each calling one of them twice on the same saved inputs, and
asserts the calls agree bit for bit. It imports no JAX: the inputs come from the
port's own projection and binning.
"""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from monogs_torch.models.gaussian_map import get_opacity, get_scales
from monogs_torch.ops import tile_raster as tr
from monogs_torch.ops.binning import tile_bin
from monogs_torch.ops.graphics import Intrinsics
from monogs_torch.ops.projection import project_gaussians_ch

W, H, TILE, CAP = 64, 48, 16, 256
N_PROCS = 12

_CHILD = textwrap.dedent("""
    import sys
    import numpy as np
    import torch
    from monogs_torch.ops import tile_raster as tr
    d = np.load(sys.argv[1])
    cfg = tr.make_raster_config(int(d["w"]), int(d["h"]), int(d["ts"]))
    if sys.argv[2] == "slab":
        a = [torch.as_tensor(d[k]) for k in ("feats", "pstart", "counts")]
        o1, t1 = tr.composite_slab(*a, cfg, int(d["cap"]), True)
        o2, t2 = tr.composite_slab(*a, cfg, int(d["cap"]), True)
        baux = torch.as_tensor(d["baux"])
        g1 = tr._bwd_slab_plain(*a, baux, cfg)
        g2 = tr._bwd_slab_plain(*a, baux, cfg)
        same = torch.equal(t1, t2) and torch.equal(g1, g2)
    else:
        dense = torch.as_tensor(d["dense"])
        o1, t1 = tr.composite_tiles_ref(dense, cfg)
        o2, t2 = tr.composite_tiles_ref(dense, cfg)
        same = torch.equal(t1, t2)
    same = same and torch.equal(o1, o2)
    print("SAME" if same else "DIFF %g" % float((o1 - o2).abs().max()))
""")



def _inputs(path):
    rng = np.random.default_rng(1)
    n = 120
    p = {"xyz": np.concatenate([rng.uniform(-0.5, 0.5, (n, 2)),
                                rng.uniform(1.0, 3.0, (n, 1))], 1),
         "log_scales": rng.uniform(-3.5, -2.5, (n, 3)),
         "quats": rng.normal(size=(n, 4)) + [2.0, 0, 0, 0],
         "opacity_logit": rng.normal(size=n) + 0.5, "rgb": rng.uniform(size=(n, 3))}
    p = {k: torch.as_tensor(v, dtype=torch.float32) for k, v in p.items()}
    intr = Intrinsics(fx=60.0, fy=60.0, cx=W / 2, cy=H / 2, width=W, height=H)
    z = torch.zeros(3)
    pr = project_gaussians_ch(p["xyz"], get_scales(p, False), p["quats"],
                              get_opacity(p), torch.eye(3), z, z, z, intr)
    opa = torch.where(pr.valid, pr.opacity, torch.zeros_like(pr.opacity))
    b = tile_bin(None, pr.radius, pr.depth, pr.valid, img_w=W, img_h=H,
                 tile_size=TILE, tile_capacity=CAP, max_dup=4, max_dup_gen=16,
                 opacity=opa, conic=(pr.ca, pr.cb, pr.cc), uv=(pr.u, pr.v))
    feats = tr.pack_features_slab(pr.u, pr.v, pr.ca, pr.cb, pr.cc, opa, p["rgb"],
                                  pr.depth, b.gauss_of_pos, b.gsort_pos,
                                  b.gseg_start, b.g_last, 4)[None].detach()
    cfg = tr.make_raster_config(W, H, TILE)
    baux = torch.randn((cfg.num_tiles, 8, cfg.pixels),
                       generator=torch.Generator().manual_seed(2))
    dense = tr.pack_features(torch.stack([pr.u, pr.v], -1),
                             torch.stack([pr.ca, pr.cb, pr.cc], -1), opa, p["rgb"],
                             pr.depth, b.index_matrix).detach()
    np.savez(path, feats=feats.numpy(), dense=dense.numpy(), pstart=b.pstart_blk.numpy(),
             counts=b.counts.numpy(), baux=baux.numpy(), w=W, h=H, ts=TILE, cap=CAP)


@pytest.mark.parametrize("mode", ["slab", "dense"])
def test_plain_twins_first_call_is_bit_identical_in_fresh_processes(tmp_path, mode):
    """mode "slab": the slab forward and backward twins; "dense": the dense
    oracle `composite_tiles_ref` (the `backend="ref"` path), each as the
    first compositing call of its process."""
    path = str(tmp_path / "slab.npz")
    _inputs(path)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root + os.pathsep + os.environ.get("PYTHONPATH", ""))
    env.pop("OMP_NUM_THREADS", None)     # the default thread count shows it
    # Two at a time: the fault is a first-call race between intra-op
    # threads, which a fully loaded machine hides.
    results = []
    for i in range(0, N_PROCS, 2):
        procs = [subprocess.Popen([sys.executable, "-c", _CHILD, path, mode], env=env,
                                  stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                  text=True) for _ in range(2)]
        for proc in procs:
            out, err = proc.communicate(timeout=120)
            assert proc.returncode == 0, err
            results.append(out.strip().splitlines()[-1])
    assert results == ["SAME"] * N_PROCS, results


def test_warm_cpu_math_keeps_the_thread_count():
    n = torch.get_num_threads()
    tr.warm_cpu_math.cache_clear()
    tr.warm_cpu_math()
    assert torch.get_num_threads() == n
