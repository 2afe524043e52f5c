"""monogs_torch's phase ledger and resume through its command line,
`main(argv)` in this process, on the CPU (the port of
tests/test_phase_resume.py, which drives slam.py in subprocesses): a full
run with --refine and --eval, then a simulated death after the refinement
(metrics.json and the eval artifacts deleted), and a --resume-run that
must regenerate the same quality numbers from the phase checkpoints
without running the frame loop or the refinement again. Then an async run
that checkpoints every second keyframe, continued from its checkpoint with
--resume."""

import json
import os
import shutil

import numpy as np
import pytest
import torch

from monogs_torch.__main__ import main
from test_torch_system import REPO, _no_frame_cache  # noqa: F401 (autouse: cache off)

torch.set_num_threads(2)   # the test workers share the CPUs (tests/test_torch_system.py)


def _config(tmp_path):
    cfg = tmp_path / "cfg.yaml"
    cfg.write_text(f'inherit_from: "{REPO}/configs/synthetic/cpu_smoke.yaml"\n'
                   f'Results:\n  save_dir: "{tmp_path}"\n')
    return str(cfg)


def test_kill_and_resume_refine_eval(tmp_path, monkeypatch):
    monkeypatch.chdir(REPO)
    first = main(["--config", _config(tmp_path), "--device", "cpu", "--sync",
                  "--n-frames", "5", "--refine", "8", "--eval"])
    run_dir = first["save_dir"]
    assert os.path.dirname(run_dir) == str(tmp_path / "synthetic_run")
    with open(os.path.join(run_dir, "metrics.json")) as f:
        before = json.load(f)
    with open(os.path.join(run_dir, "phase.json")) as f:
        phase = json.load(f)
    assert phase["slam_done"] and phase["refine_done_iters"] == 8
    assert os.path.exists(os.path.join(run_dir, "ckpt_slam_end", "host.json"))
    assert os.path.exists(os.path.join(run_dir, "ckpt_refined", "host.json"))

    os.remove(os.path.join(run_dir, "metrics.json"))
    shutil.rmtree(os.path.join(run_dir, "psnr"))
    after = main(["--resume-run", run_dir, "--device", "cpu", "--sync",
                  "--n-frames", "5", "--refine", "8", "--eval"])
    assert after["save_dir"] == run_dir
    with open(os.path.join(run_dir, "metrics.json")) as f:
        after = json.load(f)
    assert after["final_ate_rmse"] == pytest.approx(before["final_ate_rmse"], abs=1e-9)
    assert after["psnr"] == pytest.approx(before["psnr"], abs=1e-4)
    assert after["ssim"] == pytest.approx(before["ssim"], abs=1e-5)
    assert after["n_frames"] == before["n_frames"]
    assert after["fps"] == pytest.approx(before["fps"], rel=1e-6)
    # Neither the frame loop nor the refinement ran again: no tracking.
    assert "track.dispatch" not in after["stages"] and "refine" not in after["stages"]


def test_async_checkpoint_and_resume(tmp_path, monkeypatch):
    monkeypatch.chdir(REPO)
    cfg = _config(tmp_path)
    first = main(["--config", cfg, "--device", "cpu", "--async-mode", "--ckpt-every", "2",
                  "--n-frames", "5", "--no-phase-ckpt"])
    assert first["mode"] == "async" and first["n_frames"] == 5
    run_dir = first["save_dir"]
    assert not os.path.exists(os.path.join(run_dir, "phase.json"))
    with open(os.path.join(run_dir, "ckpt", "host.json")) as f:
        host = json.load(f)
    assert len(host["kf_history"]) == 4        # keyframes 0-3 (every frame, interval 1)
    resumed = main(["--config", cfg, "--device", "cpu", "--async-mode", "--n-frames", "8",
                    "--resume", os.path.join(run_dir, "ckpt"), "--eval"])
    slam = resumed["slam"]
    assert sorted(slam.est_poses) == list(range(8))
    assert resumed["n_frames"] == 4 and resumed["mode"] == "async"
    assert np.isfinite(resumed["final_ate_rmse"]) and resumed["map_active"] > 100


def test_single_thread_false_selects_async(tmp_path, monkeypatch):
    """A config's `single_thread: False` (the Replica configs') runs the
    concurrent mode, and --sync overrides it (slam.py's rule)."""
    monkeypatch.chdir(REPO)
    cfg = tmp_path / "cfg.yaml"
    cfg.write_text(f'inherit_from: "{REPO}/configs/synthetic/cpu_smoke.yaml"\n'
                   f'Results:\n  save_dir: "{tmp_path}"\n'
                   'Training:\n  single_thread: False\n')
    base = ["--config", str(cfg), "--device", "cpu", "--n-frames", "3", "--no-phase-ckpt"]
    assert main(base)["mode"] == "async"
    assert main(base + ["--sync"])["mode"] == "sync"
