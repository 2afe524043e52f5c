"""The control: the reference put in the program's place and computed in
the precision below the configurations' (TF32 for float32 with TF32 off on
the card; bfloat16 on the CPU, which has no TF32) comes out not correct
against each cell's limits."""

import json
import subprocess
import sys

import pytest

from slambench import core
from slambench.tests import tiny_cell

CELLS = [w["name"] for w in core.load_json(core.ROOT, "BENCHMARK.json")["workloads"]]


def _fails(limits: dict, numbers: dict) -> list:
    return [k for k, v in numbers.items() if k in limits and v > limits[k]]


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct_on_the_cpu(cell):
    r = tiny_cell.run(cell, controls=("bf16",))
    limits = core.cell_files(cell)["limits"]
    assert _fails(limits, r["_info"]["controls"]["bf16"]), r["_info"]["controls"]
    assert not _fails(limits, {k: c["value"] for k, c in r["checks"].items()})


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct_on_the_card(cell, cuda):
    out = subprocess.run([sys.executable, "slambench/calibrate.py", "--workload", cell,
                          "--seconds", "20", "--seeds", "7001", "--controls", "tf32"],
                         cwd=core.ROOT, capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-3000:]
    rec = json.loads(out.stdout.strip().splitlines()[-1])
    limits = core.cell_files(cell)["limits"]
    assert _fails(limits, rec["controls"]["tf32"]), rec["controls"]
