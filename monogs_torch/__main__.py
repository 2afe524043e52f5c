"""Command line: a SLAM run of a YAML config (the port of slam.py).

    python -m monogs_torch --config configs/synthetic/room.yaml --eval
    python -m monogs_torch --config configs/synthetic/cpu_smoke.yaml --device cpu --eval
    python -m monogs_torch --config configs/synthetic/room.yaml --refine-curve 0,400
    python -m monogs_torch --config configs/synthetic/room_mono.yaml --ate-align-scale
    python -m monogs_torch --config configs/synthetic/room.yaml --async-mode --ckpt-every 3
    python -m monogs_torch --config configs/synthetic/room.yaml --resume RUN_DIR/ckpt
    python -m monogs_torch --resume-run RUN_DIR --eval
    python -m monogs_torch --config configs/synthetic/room.yaml --viewer 8890
    python -m monogs_torch --config MESH2.yaml --device cpu \
        --dist-coordinator 127.0.0.1:29512 --dist-procs 2 --dist-rank R   (R = 0, 1)

Creates <Results.save_dir>/<dataset type>_<scene>/<timestamp>/ (with
--resume-run: RUN_DIR itself) with the merged config (config.yml), runs
the frame loop, synchronous (`SLAM.run`) or with the tracker and mapper
concurrent (`SLAM.run_async`: --async-mode, or a config's single_thread:
False, unless --sync), then the colour refinement (--refine N iterations;
--refine-curve refines on to each cumulative milestone and evaluates
there, into refine_curve.json), optionally the rendering evaluation (PSNR /
SSIM over every 5th non-keyframe frame) and the aligned ATEs, and writes
the final PLY and metrics.json (the JAX CLI's keys). `main(argv)` returns
the metrics.json dict.

Checkpoints (utils/ckpt.py): --ckpt-every N writes RUN_DIR/ckpt every N
keyframes, and --resume CKPT_DIR continues the frame loop after the
checkpoint's last frame. The phase ledger RUN_DIR/phase.json records the
frame loop and --refine as each completes, with the whole state in
RUN_DIR/ckpt_slam_end and RUN_DIR/ckpt_refined (--no-phase-ckpt: neither);
--resume-run RUN_DIR skips every phase it records complete (a run that
died in its frame loop continues from RUN_DIR/ckpt) and writes the
artifacts of the rest, metrics.json among them.

--viewer PORT serves the live web viewer (viewer/server.py) during the run.
--dist-coordinator / --dist-procs / --dist-rank start one rank of a
multi-process run (parallel/distributed.py: NCCL on CUDA, each rank on its
card, gloo on the CPU); with System.mesh_devices set to the process count
the mapper's window shards over the ranks. Every rank runs the frame loop
and the refinement; the primary (rank 0) alone serves the viewer, writes
the phase ledger, evaluates and writes metrics.json, and the others write
their run directories under <Results.save_dir>/rank<R>/.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch
import yaml


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m monogs_torch",
                                 description="Gaussian Splatting SLAM on PyTorch / CUDA")
    ap.add_argument("--config", default=None,
                    help="YAML config path (with --resume-run: default the run's config.yml)")
    ap.add_argument("--eval", action="store_true",
                    help="run the rendering evaluation (PSNR / SSIM) at the end")
    ap.add_argument("--n-frames", type=int, default=None,
                    help="process only the first N frames")
    ap.add_argument("--backend", default=None, choices=["ref", "slab"],
                    help="rasterizer backend (default: the config's System.backend, "
                         "where 'pallas' means 'slab')")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the run (default cuda; cpu runs the "
                         "kernels' plain twins)")
    ap.add_argument("--refine", type=int, default=0,
                    help="colour refinement iterations after the frame loop")
    ap.add_argument("--refine-curve", default=None, metavar="N1,N2,...",
                    help="refine on to each cumulative milestone (counting --refine) "
                         "and evaluate PSNR / SSIM there; writes refine_curve.json")
    ap.add_argument("--ate-align", action="store_true",
                    help="also report the ATE after an Umeyama alignment")
    ap.add_argument("--ate-align-scale", action="store_true",
                    help="also report the ATE after a Sim(3) alignment (monocular)")
    ap.add_argument("--async-mode", action="store_true",
                    help="run the tracker and the mapper concurrently")
    ap.add_argument("--sync", action="store_true",
                    help="run synchronously even where the config sets single_thread: False")
    ap.add_argument("--ckpt-every", type=int, default=None, metavar="N",
                    help="checkpoint the whole SLAM state every N keyframes")
    ap.add_argument("--resume", default=None, metavar="CKPT_DIR",
                    help="continue the frame loop from a checkpoint directory")
    ap.add_argument("--resume-run", default=None, metavar="RUN_DIR",
                    help="resume a run in place: skip the phases RUN_DIR/phase.json "
                         "records complete and rerun the rest")
    ap.add_argument("--no-phase-ckpt", action="store_true",
                    help="write no phase checkpoints (and so no phase.json)")
    ap.add_argument("--viewer", type=int, default=0, metavar="PORT",
                    help="serve the live web viewer on this port")
    ap.add_argument("--dist-coordinator", default=None, metavar="HOST:PORT",
                    help="rank 0's address in a multi-process run")
    ap.add_argument("--dist-procs", type=int, default=None,
                    help="the process count of a multi-process run")
    ap.add_argument("--dist-rank", type=int, default=None,
                    help="this process's rank in a multi-process run")
    return ap


def _jsonable(x):
    """metrics as JSON: tensors and numpy scalars to numbers or lists."""
    if isinstance(x, dict):
        return {k: _jsonable(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_jsonable(v) for v in x]
    if isinstance(x, (str, bool, int, float)) or x is None:
        return x
    a = x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)
    return a.item() if a.size == 1 else a.tolist()


def main(argv: list[str] | None = None) -> dict:
    ap = _parser()
    args = ap.parse_args(argv)
    if args.resume_run:
        args.config = args.config or os.path.join(args.resume_run, "config.yml")
    if not args.config:
        ap.error("--config is required (unless --resume-run is given)")

    from .data import load_dataset
    from .parallel.distributed import (
        initialize_distributed,
        is_primary,
        rank_device,
        sync_hosts,
    )
    from .slam.system import SLAM
    from .utils import profiling
    from .utils.config import (
        build_keyframe_config,
        build_mapper_config,
        build_system_config,
        build_tracker_config,
        load_config,
    )
    from .utils.logging import Log

    initialize_distributed(args.dist_coordinator, args.dist_procs, args.dist_rank,
                           device=args.device)
    device = rank_device(args.device)
    primary = is_primary()
    if device.type == "cuda":
        # Full float32 in every product and convolution on the card.
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    profiling.reset()

    config = load_config(args.config)
    scfg = build_system_config(config)
    backend = args.backend or scfg.backend

    ds_cfg = config.get("Dataset", {})
    scene = os.path.basename(os.path.normpath(ds_cfg.get("dataset_path", "run")))
    stamp = time.strftime("%Y-%m-%d-%H-%M-%S")
    save_root = config.get("Results", {}).get("save_dir", "results")
    save_dir = os.path.join(save_root, f"{ds_cfg.get('type', 'x')}_{scene}", stamp)
    if args.resume_run:
        # In place: the saved config.yml names the original save root.
        save_dir = args.resume_run
    if not primary:
        save_dir = os.path.join(save_root, f"rank{torch.distributed.get_rank()}",
                                f"{ds_cfg.get('type', 'x')}_{scene}", stamp)
    os.makedirs(save_dir, exist_ok=True)
    config.setdefault("Results", {})["save_dir"] = save_dir
    scfg.save_dir = save_dir
    with open(os.path.join(save_dir, "config.yml"), "w") as f:
        yaml.safe_dump(config, f)
    Log(f"Results -> {save_dir}", tag="System")

    dataset = load_dataset(config, device=device)
    slam = SLAM(dataset, config=config,
                tracker_config=build_tracker_config(config, backend=backend),
                mapper_config=build_mapper_config(config, backend=backend),
                keyframe_config=build_keyframe_config(config), system_config=scfg,
                device=device)
    if args.ckpt_every is not None:
        slam.scfg.ckpt_every = args.ckpt_every
    if args.viewer and primary:
        slam.start_viewer(port=args.viewer)
    from .utils.ckpt import load_checkpoint, save_checkpoint

    start_frame = 0
    resume_from = args.resume
    phase_path = os.path.join(save_dir, "phase.json")
    if (not resume_from and args.resume_run and not os.path.exists(phase_path)
            and os.path.isdir(os.path.join(save_dir, "ckpt"))):
        resume_from = os.path.join(save_dir, "ckpt")    # died in the frame loop
    if resume_from:
        load_checkpoint(resume_from, slam)
        start_frame = max(slam.est_poses) + 1
        Log(f"Resumed from {resume_from} at frame {start_frame}", tag="System")
    slam.prewarm()
    use_async = (args.async_mode or not slam.scfg.single_thread) and not args.sync

    phase = {}
    if args.resume_run and os.path.exists(phase_path):
        with open(phase_path) as f:
            phase = json.load(f)

    def phase_done(name: str):
        """The state to save_dir/<name> and the ledger to phase.json."""
        if args.no_phase_ckpt or not primary:
            return
        save_checkpoint(os.path.join(save_dir, name), slam)
        with open(phase_path + ".tmp", "w") as f:
            json.dump(_jsonable(phase), f)
        os.replace(phase_path + ".tmp", phase_path)

    if phase.get("slam_done"):
        load_checkpoint(os.path.join(save_dir, "ckpt_refined" if phase.get("refine_done_iters")
                                     else "ckpt_slam_end"), slam)
        slam.metrics.update(phase["metrics"])
        rmse = phase["rmse"]
        Log(f"Resumed run {save_dir} past the frame loop (refinement done: "
            f"{phase.get('refine_done_iters', 0)})", tag="System")
    else:
        run = slam.run_async if use_async else slam.run
        rmse = run(n_frames=args.n_frames, start_frame=start_frame)
        phase = {"slam_done": True, "rmse": rmse, "metrics": slam.metrics}
        phase_done("ckpt_slam_end")
    if args.refine:
        done_iters = int(phase.get("refine_done_iters", 0))
        if done_iters < args.refine:
            slam.refine(iters=args.refine - done_iters)
            phase["refine_done_iters"] = args.refine
            phase["metrics"] = slam.metrics
            phase_done("ckpt_refined")
        else:
            Log(f"refinement already done ({done_iters} iterations)", tag="System")
    refine_curve = []
    if args.refine_curve:
        done = args.refine
        for m in sorted(int(x) for x in args.refine_curve.split(",")):
            if m > done:
                slam.refine(iters=m - done)
                done = m
            if not primary:
                continue
            r = slam.eval_rendering(every=5, label=f"refine{m}")
            refine_curve.append({"iters": m, "psnr": float(r["mean_psnr"]),
                                 "ssim": float(r["mean_ssim"])})
            Log(f"refine {m}: PSNR {r['mean_psnr']:.2f} SSIM {r['mean_ssim']:.3f}",
                tag="Eval")
        if primary:
            with open(os.path.join(save_dir, "refine_curve.json"), "w") as f:
                json.dump(refine_curve, f, indent=1)

    eval_res = None
    if primary and (args.eval or config.get("Results", {}).get("eval_rendering", False)):
        eval_res = slam.eval_rendering(every=5)
        Log(f"PSNR {eval_res['mean_psnr']:.2f} SSIM {eval_res['mean_ssim']:.3f}",
            tag="Eval")
    if args.ate_align and primary:
        Log(f"aligned ATE {slam.eval_ate(label='aligned', align=True):.4f}", tag="Eval")
    if args.ate_align_scale and primary:
        rs = slam.eval_ate(label="aligned_scale", align=True, align_scale=True)
        Log(f"scale-aligned ATE {rs:.4f}", tag="Eval")

    summary = {
        "config": os.path.basename(args.config),
        "n_frames": len(slam.metrics["frame_times"]),
        "fps": slam.metrics.get("fps"),
        "wall_s": slam.metrics.get("wall_s"),
        "final_ate_rmse": rmse,
        "tracking_iters_mean": (float(sum(slam.metrics["tracking_iters"]))
                                / max(len(slam.metrics["tracking_iters"]), 1)),
        "overflow_max": max(slam.metrics["overflow"], default=0),
        "n_keyframes": len(slam.kf_history),
        "map_active": int(slam.state.gmap.num_active),
        "mode": "async" if use_async else "sync",
        "refine_iters": args.refine,
    }
    if eval_res is not None:
        summary["psnr"] = float(eval_res["mean_psnr"])
        summary["ssim"] = float(eval_res["mean_ssim"])
        if eval_res.get("train_view_inflated"):
            summary["psnr_train_view_inflated"] = True
    if refine_curve:
        summary["refine_curve"] = refine_curve
    if "refine_overflow_max" in slam.metrics:
        summary["refine_overflow_max"] = slam.metrics["refine_overflow_max"]
    stages = profiling.summary()
    summary["counters"] = stages.pop("counters", {})
    summary["stages"] = stages
    if primary:
        with open(os.path.join(save_dir, "metrics.json"), "w") as f:
            json.dump(summary, f, indent=1)
    slam.wandb.finish()
    if slam.viewer is not None:
        slam.viewer.stop()
    sync_hosts()
    summary["save_dir"] = save_dir
    summary["slam"] = slam
    return summary


if __name__ == "__main__":
    main()
    if torch.distributed.is_initialized():
        # Every rank stops its process group (NCCL's watchdog) before it
        # exits, so that no rank outlives rank 0's store.
        torch.distributed.destroy_process_group()
