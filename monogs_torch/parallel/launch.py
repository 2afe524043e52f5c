"""Local ranks: n processes on one machine, joined on a localhost port (the
one launcher of the port's multi-process runs: the dry run, the tests and
the command line's ranks below).

    python -m monogs_torch.parallel.launch --ranks 4 --config configs/synthetic/room.yaml --n-frames 6 --eval
    python -m monogs_torch.parallel.launch --ranks 2 --config configs/synthetic/cpu_smoke.yaml --device cpu

As a command it writes a config inheriting --config with
System.mesh_devices N and its Results.save_dir in --out, starts
`python -m monogs_torch` N times with --dist-coordinator / --dist-procs /
--dist-rank on localhost (one rank a card on CUDA, gloo on the CPU; N = 1
starts one process and no group, so mesh_devices 1 makes its group of
one), each within --timeout seconds, and prints one JSON line: rank 0's
metrics.json figures, the wall time until the last rank ended, and
whether every rank's final map (its PLY) equals rank 0's byte for byte.
Exits non-zero if a rank fails or the maps differ.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def free_port() -> int:
    """A localhost port that no socket holds now."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def start_ranks(n: int, command, env: dict | None = None, log_dir: str | None = None) -> list:
    """Start `command(rank)` (an argv list) for ranks 0 ... n-1 from the
    repo's root, the repo first on PYTHONPATH; each rank's stdout and
    stderr piped, or with `log_dir` written to log_dir/rank<r>.log.
    -> the processes."""
    env = dict(os.environ if env is None else env)
    env["PYTHONPATH"] = os.pathsep.join(
        [REPO] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])
    procs = []
    for r in range(n):
        if log_dir is None:
            out, err = subprocess.PIPE, subprocess.PIPE
        else:
            out, err = open(os.path.join(log_dir, f"rank{r}.log"), "w"), subprocess.STDOUT
        procs.append(subprocess.Popen(command(r), cwd=REPO, env=env, stdout=out, stderr=err,
                                      text=True))
        if log_dir is not None:
            out.close()
    return procs


def join_ranks(procs: list, timeout: float) -> list:
    """Wait for each rank within `timeout` s of its own (a hung collective
    raises subprocess.TimeoutExpired instead of hanging); every rank still
    running at the end is killed. -> each rank's (exit code, stdout,
    stderr), the streams None where they went to a log."""
    res = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=timeout)
            res.append((p.returncode, out, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m monogs_torch.parallel.launch")
    ap.add_argument("--ranks", type=int, required=True)
    ap.add_argument("--config", required=True)
    ap.add_argument("--out", default=os.path.join("build", "multi_rank"))
    ap.add_argument("--timeout", type=float, default=900.0)
    args, rest = ap.parse_known_args(argv)
    out = os.path.abspath(os.path.join(args.out, f"ranks{args.ranks}"))
    os.makedirs(out, exist_ok=True)
    cfg = os.path.join(out, "config.yaml")
    with open(cfg, "w") as f:
        f.write(f'inherit_from: "{os.path.abspath(args.config)}"\n'
                f'System:\n  mesh_devices: {args.ranks}\nResults:\n  save_dir: "{out}"\n')
    dist = [] if args.ranks == 1 else ["--dist-coordinator", f"127.0.0.1:{free_port()}",
                                       "--dist-procs", str(args.ranks)]
    t0 = time.perf_counter()
    procs = start_ranks(args.ranks, lambda r: [
        sys.executable, "-m", "monogs_torch", "--config", cfg, *rest, *dist,
        *(["--dist-rank", str(r)] if dist else [])], log_dir=out)
    codes = [rc for rc, _, _ in join_ranks(procs, args.timeout)]
    wall = time.perf_counter() - t0
    failed = [r for r, rc in enumerate(codes) if rc]
    runs = sorted(d for d, _, fs in os.walk(out) if "config.yml" in fs)
    plys = {}
    for d in runs:
        rank = next((int(part[4:]) for part in d[len(out):].split(os.sep)
                     if part.startswith("rank") and part[4:].isdigit()), 0)
        with open(os.path.join(d, "point_cloud", "final", "point_cloud.ply"), "rb") as f:
            plys[rank] = (d, f.read())
    metrics = {}
    if 0 in plys:
        with open(os.path.join(plys[0][0], "metrics.json")) as f:
            metrics = json.load(f)
    same = len(plys) == args.ranks and all(b == plys[0][1] for _, b in plys.values())
    print(json.dumps({
        "ranks": args.ranks, "failed": failed, "maps_equal": same,
        "wall_s": wall, "fps": metrics.get("fps"), "frame_loop_s": metrics.get("wall_s"),
        "ate_rmse": metrics.get("final_ate_rmse"), "psnr": metrics.get("psnr"),
        "map_active": metrics.get("map_active"), "n_frames": metrics.get("n_frames"),
        "stages": {k: v["total_s"] for k, v in metrics.get("stages", {}).items()}}))
    return 1 if failed or not same else 0


if __name__ == "__main__":
    sys.exit(main())
