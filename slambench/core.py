"""One run of one cell: set-up, the measured window, the correctness check
and the metrics, as the benchmark's command runs them.

Everything of a cell is found by name: its entry in BENCHMARK.json, its
configuration (`configs/<config>.yaml`), its traffic
(`workloads/<cell>.json`, whose `driver` names `drivers/<driver>.py`), its
limits (`limits/<cell>.json`) and each per-layer metric's reader
(`metrics/<metric>.py`).
"""

from __future__ import annotations

import gc
import importlib
import json
import math
import os
import sys
import time

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
FORBIDDEN = ("jax", "jaxlib", "flax", "monogs_tpu")


def prepare_environment(config: dict | None = None):
    """Caches at fixed paths inside the checkout; no synthetic disk cache;
    nothing that loads JAX; the host threads the configuration's deployment
    states (Benchmark: process: omp_num_threads). Before torch or the
    program is imported."""
    os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, "build", "triton")
    os.environ["MONOGS_SYNTH_CACHE"] = "0"
    os.environ["USE_FLAX"] = "0"
    threads = ((config or {}).get("Benchmark", {}).get("process", {}).get("omp_num_threads"))
    if threads is not None:
        os.environ["OMP_NUM_THREADS"] = str(int(threads))


def load_json(*parts):
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def cell_files(cell: str) -> dict:
    """The cell's BENCHMARK.json entries and files, by name."""
    bench = load_json(ROOT, "BENCHMARK.json")
    entry = next((w for w in bench["workloads"] if w["name"] == cell), None)
    if entry is None:
        raise SystemExit(f"no workload named {cell!r} in BENCHMARK.json")
    import yaml

    with open(os.path.join(BENCH_DIR, "configs", f"{entry['config']}.yaml")) as f:
        config = yaml.safe_load(f)
    limits_path = os.path.join(BENCH_DIR, "limits", f"{cell}.json")

    def listed(m):
        return "workloads" not in m or cell in m["workloads"]

    return {
        "entry": entry, "config": config,
        "workload": load_json(BENCH_DIR, "workloads", f"{cell}.json"),
        "limits": load_json(limits_path) if os.path.exists(limits_path) else None,
        "end_to_end": [m for m in bench["end_to_end"] if listed(m)],
        "per_layer": [m for m in bench["per_layer"] if listed(m)],
    }


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def setup(files: dict, seed: int, device, config_overrides=None) -> dict:
    """Scene, frames, the SLAM system and its initialisation (frame 0)."""
    import torch

    from monogs_torch.ops.graphics import Intrinsics
    from monogs_torch.slam.system import SLAM
    from monogs_torch.utils import config as pcfg

    from . import dataset

    config = json.loads(json.dumps(files["config"]))
    if config_overrides:
        pcfg.update_recursive(config, config_overrides)
    torch.manual_seed(int(seed) % (2 ** 63))
    workload = files["workload"]
    n_frames = min(int(workload["frames_rendered"]),
                   int(config["Dataset"]["synthetic"]["n_frames"]))
    backend = config.get("System", {}).get("backend", "slab")
    t0 = time.perf_counter()
    frames = dataset.render_frames(config, seed, n_frames, device)
    ds = dataset.StreamDataset(config, frames, Intrinsics)
    render_s = time.perf_counter() - t0
    slam = SLAM(ds, config=config,
                tracker_config=pcfg.build_tracker_config(config, backend=backend),
                mapper_config=pcfg.build_mapper_config(config, backend=backend),
                keyframe_config=pcfg.build_keyframe_config(config),
                system_config=pcfg.build_system_config(config), device=device)
    slam.prewarm()
    t1 = time.perf_counter()
    slam.process_frame(0)
    if slam.device.type == "cuda":
        torch.cuda.synchronize(slam.device)
    return {"slam": slam, "frames": frames, "config": config, "camera": dataset.camera_of(config),
            "render_s": render_s, "init_s": time.perf_counter() - t1}


def _sync(device):
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def kernel_work(ks, slab: int) -> dict:
    """Per kernel: the sampled launches' work and time, and per (kernel,
    phase) the mean work of a launch and the traced cycle's launch count."""
    from . import roofline

    out: dict = {}
    for s in ks.samples:
        name, phase = s["key"]
        ops, nbytes = roofline.launch_work(name, s["feats"], s["pstart"], s["counts"], s["cfg"],
                                           slab, s.get("touched", False), s.get("K", 0))
        sec = s["ev"][0].elapsed_time(s["ev"][1]) * 1e-3
        k = out.setdefault(name, {"ideal_s": 0.0, "time_s": 0.0, "n": 0, "phases": {}})
        k["ideal_s"] += roofline.ideal_seconds(ops, nbytes)
        k["time_s"] += sec
        k["n"] += 1
        ph = k["phases"].setdefault(phase, {"ops": 0.0, "n": 0})
        ph["ops"] += ops
        ph["n"] += 1
    for (name, phase), n in ks.counts.items():
        ph = out.setdefault(name, {"ideal_s": 0.0, "time_s": 0.0, "n": 0, "phases": {}})
        ph = ph["phases"].setdefault(phase, {"ops": 0.0, "n": 0})
        ph["launches"] = n
    return out


def read_metrics(specs: list, ctx: dict) -> dict:
    """Each metric's reader, found by name; a reader that finds nothing
    returns None and the metric is left out."""
    out = {}
    for m in specs:
        mod = importlib.import_module(f"slambench.metrics.{m['name']}")
        v = mod.read(ctx)
        if v is not None and math.isfinite(v):
            out[m["name"]] = {"value": v, "unit": m["unit"]}
    return out


def run_cell(cell: str, seed: int, seconds: float, trace: bool, device="cuda",
             t_start=None, config_overrides=None, files=None, controls=()) -> dict:
    """One run; -> the result object (correct, attempted, failed, metrics,
    device, [breakdown], checks). `controls` names reference precisions
    ("tf32", "bf16") whose numbers on the same captures go to
    result["_info"]["controls"] (the calibration's control; a run of the
    benchmark computes none)."""
    t_start = time.perf_counter() if t_start is None else t_start
    import torch

    from monogs_torch.ops.binning import SLAB
    from monogs_torch.utils import profiling

    from . import capture, correctness

    files = files or cell_files(cell)
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    if on_card:
        # The deployment's setting: full float32 in products and convolutions.
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.cuda.set_device(dev)
        torch.zeros(1, device=dev)
        torch.cuda.reset_peak_memory_stats()
    dropped: list = []
    with capture.install_overflow(dropped):
        st = setup(files, seed, dev, config_overrides)
        slam, workload, config = st["slam"], files["workload"], st["config"]
        setup_s = time.perf_counter() - t_start
        driver = importlib.import_module(f"slambench.drivers.{workload['driver']}")
        profiling.reset()
        cap = capture.Captures()
        with capture.install(cap):
            win = driver.run(slam, workload, seconds,
                             on_keyframe=lambda idx: cap.next_keyframe_event())
        _sync(dev)
        sections = profiling.summary()
        iters = slam.metrics["tracking_iters"][-len(win["frames"]):] if win["frames"] else []
        ks = capture.KernelSamples()
        traced = {"traces": {}, "attempted": 0, "failed": 0}
        if trace and on_card:
            with capture.install_kernel_sampling(ks):
                traced = driver.trace(slam, win, on_cycle=lambda on: setattr(ks, "on", on))
            _sync(dev)
    mem_peak = int(torch.cuda.max_memory_allocated()) if on_card else 0
    attempted, failed = win["attempted"] + traced["attempted"], win["failed"] + traced["failed"]
    bench = config["Benchmark"]
    ate = correctness.ate_number(slam.est_poses, st["frames"]["poses"],
                                 bench["ate"]["align"])
    iso = bool(config.get("Gaussians", {}).get("isotropic", False))
    use_depth = bool(config["Dataset"]["synthetic"].get("use_depth", True))
    del slam, st["slam"]
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    nums, ref_s = correctness.numbers(cap, st["frames"], st["camera"], iso, use_depth,
                                      workload["checks"], seed)
    nums["ate_m"] = ate
    nums["dropped_entries"] = correctness.dropped_entries(dropped)
    control = {p: correctness.numbers(cap, st["frames"], st["camera"], iso, use_depth,
                                      workload["checks"], seed, precision=p)[0]
               for p in controls}
    limits = dict(files["limits"] or {})
    limits["ate_m"] = float(bench["ate"]["limit_m"])
    checks = {k: {"value": nums[k], "limit": limits.get(k)} for k in sorted(nums)}
    correct = (failed == 0 and win["attempted"] > 0
               and all(c["limit"] is not None and c["value"] <= c["limit"] for c in checks.values()))

    ctx = {"window": win, "sections": sections, "track_iters": iters,
           "kernels": kernel_work(ks, SLAB) if trace and on_card else {},
           "traces": traced["traces"]}
    if trace:
        metrics = read_metrics(files["per_layer"], ctx)
    else:
        metrics = {"setup_s": {"value": setup_s, "unit": "s"}}
        metrics.update(read_metrics([m for m in files["end_to_end"] if m["name"] != "setup_s"],
                                    ctx))
    result = {"correct": bool(correct), "attempted": attempted, "failed": failed,
              "metrics": metrics,
              "device": {"platform": "gpu" if on_card else "cpu",
                         "kind": torch.cuda.get_device_name() if on_card else "cpu",
                         "count": 1, "memory_peak_bytes": mem_peak}}
    cyc = traced["traces"].get("cycle")
    if cyc is not None:
        result["device"].update(busy_s=cyc["busy_s"], window_s=cyc["window_s"])
        result["breakdown"] = {"device_ops": cyc["device_ops"], "idle_gaps": cyc["idle_gaps"]}
    result["checks"] = checks
    result["_info"] = {"render_s": st["render_s"], "init_s": st["init_s"], "reference_s": ref_s,
                       "frames": len(win["frames"]), "whole_frames": len(win["whole_frames"]),
                       "keyframes": win["keyframes"], "window_s": win["window_s"],
                       "map_captures": len(cap.maps),
                       "track_captures": len(cap.tracks), "controls": control}
    return result
