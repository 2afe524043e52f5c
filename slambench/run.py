"""The benchmark of monogs_torch on one NVIDIA H100: one run of one cell.

    python3 slambench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout. It builds the cell's inputs from the seed,
sets the system up (counted as setup_s), measures for --seconds, checks
what the timed path produced against the plain reference, and prints one
JSON object as its last line of standard output: the cell's end-to-end
metrics with --trace 0, its per-layer metrics with --trace 1. The numbers
compared, each beside its limit, are the last lines of standard error and
the last key of that object. It exits non-zero, with no result, without a
CUDA card, and where JAX or the JAX package got loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from slambench import core  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    files = core.cell_files(args.workload)
    core.prepare_environment(files["config"])
    import torch

    need = int(files["entry"].get("chips", 1))
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        print(f"slambench: needs {need} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 1
    result = core.run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                           device="cuda:0", t_start=T_START, files=files)
    info = result.pop("_info")
    print("slambench: " + json.dumps(info), file=sys.stderr)
    bad = core.forbidden_modules()
    if bad:
        print(f"slambench: the run loaded {', '.join(bad)}", file=sys.stderr)
        return 1
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
