"""monogs_torch's command line, `python -m monogs_torch`, on the CPU:
configs/synthetic/cpu_smoke.yaml with --device cpu --backend slab (the
card's path, through the kernels' plain twins) --eval --ate-align
--refine 8 --refine-curve 8,16 writes every artifact, the refinement curve
among them.
"""

import json
import os

import numpy as np
import torch

from test_torch_system import REPO, _no_frame_cache  # noqa: F401 (autouse: cache off)

torch.set_num_threads(2)   # the test workers share the CPUs (tests/test_torch_system.py)


def test_cli_writes_every_artifact(tmp_path, monkeypatch):
    from monogs_torch.__main__ import main
    from monogs_torch.utils.ply import load_ply

    monkeypatch.chdir(REPO)
    cfg = tmp_path / "cpu_smoke_here.yaml"
    cfg.write_text(f'inherit_from: "{REPO}/configs/synthetic/cpu_smoke.yaml"\n'
                   f'Results:\n  save_dir: "{tmp_path}"\n')
    out = main(["--config", str(cfg), "--device", "cpu", "--backend", "slab", "--eval",
                "--ate-align", "--refine", "8", "--refine-curve", "8,16"])
    d = out["save_dir"]
    assert d.startswith(str(tmp_path))
    with open(os.path.join(d, "plot", "trj_final.json")) as f:
        trj = json.load(f)
    assert trj["trj_id"] == list(range(8))
    with open(os.path.join(d, "plot", "stats_aligned.json")) as f:
        assert json.load(f)["aligned"] is True
    with open(os.path.join(d, "psnr", "final", "final_result.json")) as f:
        ev = json.load(f)
    assert ev["n_frames"] >= 1 and ev["mean_lpips"] is None
    with open(os.path.join(d, "metrics.json")) as f:
        metrics = json.load(f)
    for k in ("config", "n_frames", "fps", "wall_s", "final_ate_rmse",
              "tracking_iters_mean", "overflow_max", "n_keyframes", "map_active",
              "mode", "refine_iters", "psnr", "ssim", "stages", "refine_curve",
              "refine_overflow_max"):
        assert k in metrics, k
    with open(os.path.join(d, "refine_curve.json")) as f:
        curve = json.load(f)
    assert [c["iters"] for c in curve] == [8, 16] and metrics["refine_curve"] == curve
    assert all(np.isfinite([c["psnr"], c["ssim"]]).all() for c in curve)
    assert metrics["refine_iters"] == 8 and metrics["stages"]["refine"]["n"] == 2
    # init 40 + 8 a keyframe event, then the 16 refinement iterations
    assert int(out["slam"].state.nr_iters) == 40 + 8 * (metrics["n_keyframes"] - 1) + 16
    assert out["slam"].tcfg.backend == out["slam"].mcfg.backend == "slab"
    assert metrics["n_frames"] == 8 and np.isfinite(metrics["final_ate_rmse"])
    assert metrics["stages"]["track.readback"]["n"] == 7
    ply = load_ply(os.path.join(d, "point_cloud", "final", "point_cloud.ply"))
    assert 0 < ply["xyz"].shape[0] == metrics["map_active"]
    assert os.path.exists(os.path.join(d, "config.yml"))
