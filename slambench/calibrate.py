"""The readings the correctness limits are set from: for each seed, one
run of the cell with a short window, its numbers against the reference
(the program's readings), and on the same captures the reference computed
in a lower precision in the program's place (the control's readings: TF32
for the configurations' float32 with TF32 off, and bfloat16 beside it).
Every seed in one process, so the kernels build once.

    python3 slambench/calibrate.py --workload <cell> --seconds 14 --seeds 11 12 13

Prints one JSON line per seed. The benchmark's own runs never run this.
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from slambench import core  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=14.0)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--controls", nargs="*", default=["tf32", "bf16"])
    args = ap.parse_args(argv)
    files = core.cell_files(args.workload)
    core.prepare_environment(files["config"])
    import torch

    if not torch.cuda.is_available():
        print("calibrate: needs a CUDA card", file=sys.stderr)
        return 1
    for seed in args.seeds:
        t0 = time.perf_counter()
        r = core.run_cell(args.workload, seed, args.seconds, False, device="cuda:0",
                          t_start=t0, files=files, controls=tuple(args.controls))
        info = r["_info"]
        print(json.dumps({"seed": seed, "program": {k: c["value"] for k, c in r["checks"].items()},
                          "controls": info.pop("controls"), "metrics": r["metrics"],
                          "info": info, "seconds": time.perf_counter() - t0}), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
