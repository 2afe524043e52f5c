"""The import check: every module the benchmark loads, compared by its
whole top-level name (the part before the first dot) with jax, jaxlib,
flax and monogs_tpu (monogs_torch begins with the same letters and is the
program under test); and the reference loads nothing of monogs_torch."""

import ast
import glob
import json
import os
import subprocess
import sys
import types

from slambench import core

FORBIDDEN = {"jax", "jaxlib", "flax", "monogs_tpu"}
BENCH_DIR = core.BENCH_DIR


def _modules(pattern):
    return sorted("slambench." + os.path.relpath(p, core.ROOT)[len("slambench/"):-3]
                  .replace("/", ".") for p in glob.glob(os.path.join(BENCH_DIR, pattern)))


def _top_names_after(imports, extra=""):
    code = (f"import sys, json, importlib; sys.path.insert(0, {core.ROOT!r});"
            f"[importlib.import_module(m) for m in {imports!r}];{extra}"
            "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert out.returncode == 0, out.stderr
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_everything_the_benchmark_loads_is_free_of_jax():
    mods = (_modules("*.py") + _modules("drivers/*.py") + _modules("metrics/*.py")
            + _modules("reference/*.py"))
    mods = [m for m in mods if not m.endswith("__init__")]
    # What a run imports of the program, beyond the harness's own modules.
    program = ["monogs_torch.slam.system", "monogs_torch.slam.mapper",
               "monogs_torch.slam.tracker", "monogs_torch.ops.kernels",
               "monogs_torch.utils.config", "monogs_torch.utils.profiling",
               "monogs_torch.ops.graphics", "monogs_torch.ops.binning", "torch.profiler"]
    names = _top_names_after(mods + program)
    assert "monogs_torch" in names and "slambench" in names
    assert not names & FORBIDDEN, names & FORBIDDEN


def test_reference_loads_nothing_of_the_program():
    names = _top_names_after(_modules("reference/*.py"))
    assert "monogs_torch" not in names
    assert not names & FORBIDDEN
    for path in glob.glob(os.path.join(BENCH_DIR, "reference", "*.py")):
        with open(path) as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                tops = {a.name.split(".")[0] for a in node.names}
            elif isinstance(node, ast.ImportFrom):
                tops = {(node.module or "").split(".")[0]} if not node.level else set()
            else:
                continue
            assert not tops & (FORBIDDEN | {"monogs_torch", "slambench"}), (path, tops)


def test_forbidden_modules_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "monogs_torch_like", types.ModuleType("x"))
    assert core.forbidden_modules() == [] or "monogs_tpu" not in core.forbidden_modules()
    monkeypatch.setitem(sys.modules, "monogs_tpu.sub", types.ModuleType("monogs_tpu.sub"))
    assert "monogs_tpu" in core.forbidden_modules()
