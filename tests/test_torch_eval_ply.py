"""monogs_torch's evaluation and PLY export against monogs_tpu's on the CPU:
the ATE with and without the Umeyama alignment (and with scale) within
1e-6 and the same trajectory artifacts; PSNR and SSIM of the same images
within 1e-5 (both float32; SSIM's blur sums in another order); the PLY
bytes identical for the same arrays, and a load round trip."""

import json

import numpy as np
import pytest
import torch

from monogs_tpu.utils import eval as je
from monogs_tpu.utils import ply as jp
from monogs_torch.utils import eval as te
from monogs_torch.utils import ply as tp

torch.set_num_threads(2)   # the test workers share the CPUs (tests/test_torch_system.py)


def _rot(rng):
    q = rng.normal(size=4)
    q /= np.linalg.norm(q)
    w, x, y, z = q
    return np.array([[1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
                     [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
                     [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]])


def _trajectories(seed, n=12):
    rng = np.random.default_rng(seed)
    gt, est = {}, {}
    R_off, t_off, s_off = _rot(rng), rng.normal(size=3), 1.3
    for i in range(n):
        R = _rot(rng).astype(np.float32)
        t = rng.normal(size=3).astype(np.float32)
        gt[i] = (R, t)
        # est = a similarity transform of gt plus noise (camera centres).
        c = -R.T @ t
        c_est = s_off * R_off @ c + t_off + 0.01 * rng.normal(size=3)
        R_est = (R @ R_off.T).astype(np.float32)
        est[i] = (R_est, (-R_est @ c_est).astype(np.float32))
    return est, gt


@pytest.mark.parametrize("align,align_scale", [(False, False), (True, False), (True, True)])
def test_ate_matches_jax(align, align_scale, tmp_path):
    est, gt = _trajectories(0)
    rt = te.eval_traj_ate(est, gt, save_dir=str(tmp_path / "t"), label="x",
                          align=align, align_scale=align_scale)
    rj = je.eval_traj_ate(est, gt, save_dir=str(tmp_path / "j"), label="x",
                          align=align, align_scale=align_scale)
    assert abs(rt - rj) <= 1e-6
    for name in ("trj_x.json", "stats_x.json"):
        with open(tmp_path / "t" / "plot" / name) as f:
            a = json.load(f)
        with open(tmp_path / "j" / "plot" / name) as f:
            b = json.load(f)
        assert a.keys() == b.keys()
        if name.startswith("stats"):
            assert a["aligned"] == align and a["n_frames"] == 12
            assert abs(a["rmse"] - b["rmse"]) <= 1e-6
        else:
            assert a["trj_id"] == b["trj_id"]
            np.testing.assert_allclose(a["trj_est"], b["trj_est"], atol=1e-12)
    if align_scale:
        assert rt < 0.05           # the similarity alignment undoes the offset


def test_umeyama_matches_jax():
    rng = np.random.default_rng(1)
    src = rng.normal(size=(20, 3))
    dst = 0.7 * src @ _rot(rng).T + 1.0 + 0.01 * rng.normal(size=(20, 3))
    for scale in (False, True):
        for a, b in zip(te.umeyama_alignment(src, dst, scale),
                        je.umeyama_alignment(src, dst, scale)):
            np.testing.assert_allclose(a, b, atol=1e-12)


def test_eval_rendering_matches_jax(tmp_path):
    rng = np.random.default_rng(2)
    gts = {i: rng.uniform(0, 1, (48, 64, 3)).astype(np.float32) for i in range(3)}
    gts[1][:10] = 0.0                       # PSNR leaves the gt == 0 elements out
    outs = {i: np.clip(g + rng.normal(0, 0.05, g.shape), 0, 1).astype(np.float32)
            for i, g in gts.items()}
    rt = te.eval_rendering(lambda i: torch.as_tensor(outs[i]), lambda i: (gts[i], None),
                           [0, 1, 2], save_dir=str(tmp_path / "t"))
    rj = je.eval_rendering(lambda i: outs[i], lambda i: (gts[i], None), [0, 1, 2],
                           save_dir=str(tmp_path / "j"))
    assert abs(rt["mean_psnr"] - rj["mean_psnr"]) <= 1e-5
    assert abs(rt["mean_ssim"] - rj["mean_ssim"]) <= 1e-5
    assert rt["n_frames"] == rj["n_frames"] == 3
    assert rt["mean_lpips"] is None
    with open(tmp_path / "t" / "psnr" / "final" / "final_result.json") as f:
        assert json.load(f) == rt


@pytest.mark.parametrize("k_scales", [1, 3])
def test_ply_bytes_match_jax_and_round_trip(k_scales, tmp_path):
    rng = np.random.default_rng(3)
    n = 257
    arrays = (rng.normal(size=(n, 3)), rng.uniform(size=(n, 3)), rng.normal(size=n),
              rng.normal(size=(n, k_scales)), rng.normal(size=(n, 4)))
    tp.save_ply(str(tmp_path / "t.ply"), *arrays)
    jp.save_ply(str(tmp_path / "j.ply"), *arrays)
    assert (tmp_path / "t.ply").read_bytes() == (tmp_path / "j.ply").read_bytes()
    back = tp.load_ply(str(tmp_path / "t.ply"))
    for key, a in zip(("xyz", "rgb", "opacity_logit", "log_scales", "quats"), arrays):
        np.testing.assert_array_equal(back[key], np.asarray(a, np.float32))
    jb = jp.load_ply(str(tmp_path / "t.ply"))
    for key in back:
        np.testing.assert_array_equal(back[key], jb[key])


def test_profiling_sections_and_trace(tmp_path):
    from torch.profiler import ProfilerActivity, profile

    from monogs_torch.utils import profiling

    profiling.reset()
    for device in (None, "cpu", torch.device("cpu")):
        with profiling.span("a", device=device):
            torch.ones(4).sum()
    s = profiling.summary()
    assert list(s) == ["a"] and s["a"]["n"] == 3 and s["a"]["total_s"] >= 0.0
    profiling.reset()
    assert profiling.summary() == {}
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.span("b", frame=4):
            torch.ones(8).cumsum(0)
    prof.export_chrome_trace(str(tmp_path / "trace.json"))
    assert '"b"' in (tmp_path / "trace.json").read_text()
    assert profiling.summary()["b"]["n"] == 1
    profiling.reset()
