"""Every cell's files are found by name, and BENCHMARK.json keeps to the
shape the harness reads."""

import importlib
import json
import os
import re

import pytest
import yaml

from slambench import core

BENCH = core.load_json(core.ROOT, "BENCHMARK.json")
CELLS = [w["name"] for w in BENCH["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_found_by_name(cell):
    files = core.cell_files(cell)
    assert isinstance(files["config"]["Benchmark"]["reduced"], list)
    importlib.import_module(f"slambench.drivers.{files['workload']['driver']}")
    assert files["limits"] is not None, f"slambench/limits/{cell}.json"
    assert set(files["limits"]) == {"dropped_entries", "render_err", "track_grad_err",
                                    "track_step_err", "map_grad_err", "map_step_err"}
    assert files["limits"]["dropped_entries"] == 0
    for m in files["end_to_end"] + files["per_layer"]:
        if m["name"] != "setup_s":
            assert hasattr(importlib.import_module(f"slambench.metrics.{m['name']}"), "read")


def test_benchmark_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in BENCH[k]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for c in BENCH["configs"]:
        assert c["file"] == f"slambench/configs/{c['name']}.yaml"
        with open(os.path.join(core.ROOT, c["file"])) as f:
            assert yaml.safe_load(f)["Benchmark"]["reduced"] == c["reduced"]
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and set(m["workloads"]) <= set(CELLS)
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_unknown_cell_is_refused():
    with pytest.raises(SystemExit):
        core.cell_files("no-such.cell")
