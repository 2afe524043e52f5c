"""Without a CUDA card a run fails and prints no result: it never falls
back to the CPU. So it does in a directory that holds only BENCHMARK.json
and the benchmark's files."""

import os
import shutil
import subprocess
import sys

import pytest

from slambench import core


def _run(cwd):
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    return subprocess.run([sys.executable, "slambench/run.py", "--workload", "room-rgbd-320.stream",
                           "--seed", "2147483659", "--seconds", "1", "--trace", "0"],
                          cwd=cwd, capture_output=True, text=True, timeout=300, env=env)


def _no_result(out):
    assert out.returncode != 0
    assert "{" not in out.stdout


def test_no_card_no_result():
    out = _run(core.ROOT)
    _no_result(out)
    assert "CUDA" in out.stderr


def test_benchmark_files_alone_are_not_enough(tmp_path):
    shutil.copy(os.path.join(core.ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(core.BENCH_DIR, tmp_path / "slambench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    _no_result(_run(tmp_path))


@pytest.mark.gpu
def test_a_short_run_on_the_card(cuda):
    out = subprocess.run([sys.executable, "slambench/run.py", "--workload", "room-rgbd-320.stream",
                          "--seed", "2147483659", "--seconds", "20", "--trace", "0"],
                         cwd=core.ROOT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    import json

    r = json.loads(out.stdout.strip().splitlines()[-1])
    assert r["correct"] and r["device"]["platform"] == "gpu"
