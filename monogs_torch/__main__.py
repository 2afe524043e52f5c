"""Command line: the synchronous SLAM run of a YAML config (the port of
slam.py's synchronous path).

    python -m monogs_torch --config configs/synthetic/room.yaml --eval
    python -m monogs_torch --config configs/synthetic/cpu_smoke.yaml --device cpu --eval
    python -m monogs_torch --config configs/synthetic/room.yaml --refine-curve 0,400
    python -m monogs_torch --config configs/synthetic/room_mono.yaml --ate-align-scale

Creates <Results.save_dir>/<dataset type>_<scene>/<timestamp>/ with the
merged config (config.yml), runs `SLAM.run`, then the colour refinement
(--refine N iterations; --refine-curve refines on to each cumulative
milestone and evaluates there, into refine_curve.json), optionally the
rendering evaluation (PSNR / SSIM over every 5th non-keyframe frame) and
the aligned ATEs, and writes the final PLY and metrics.json (the JAX CLI's
keys). `main(argv)` returns the metrics.json dict.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import torch
import yaml


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m monogs_torch",
                                 description="Gaussian Splatting SLAM on PyTorch / CUDA")
    ap.add_argument("--config", required=True, help="YAML config path")
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
    return ap


def main(argv: list[str] | None = None) -> dict:
    args = _parser().parse_args(argv)

    from .data import load_dataset
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

    device = torch.device(args.device)
    if device.type == "cuda":
        # Full float32 in every product and convolution on the card.
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    profiling.reset()

    config = load_config(args.config)
    scfg = build_system_config(config)
    if not scfg.single_thread:
        raise NotImplementedError("single_thread: False asks for the concurrent "
                                  "tracker / mapper mode, not ported yet (ROADMAP "
                                  "Queue 1 item 13)")
    backend = args.backend or scfg.backend

    ds_cfg = config.get("Dataset", {})
    scene = os.path.basename(os.path.normpath(ds_cfg.get("dataset_path", "run")))
    stamp = time.strftime("%Y-%m-%d-%H-%M-%S")
    save_root = config.get("Results", {}).get("save_dir", "results")
    save_dir = os.path.join(save_root, f"{ds_cfg.get('type', 'x')}_{scene}", stamp)
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
    slam.prewarm()
    rmse = slam.run(n_frames=args.n_frames)
    if args.refine:
        slam.refine(iters=args.refine)
    refine_curve = []
    if args.refine_curve:
        done = args.refine
        for m in sorted(int(x) for x in args.refine_curve.split(",")):
            if m > done:
                slam.refine(iters=m - done)
                done = m
            r = slam.eval_rendering(every=5, label=f"refine{m}")
            refine_curve.append({"iters": m, "psnr": float(r["mean_psnr"]),
                                 "ssim": float(r["mean_ssim"])})
            Log(f"refine {m}: PSNR {r['mean_psnr']:.2f} SSIM {r['mean_ssim']:.3f}",
                tag="Eval")
        with open(os.path.join(save_dir, "refine_curve.json"), "w") as f:
            json.dump(refine_curve, f, indent=1)

    eval_res = None
    if args.eval or config.get("Results", {}).get("eval_rendering", False):
        eval_res = slam.eval_rendering(every=5)
        Log(f"PSNR {eval_res['mean_psnr']:.2f} SSIM {eval_res['mean_ssim']:.3f}",
            tag="Eval")
    if args.ate_align:
        Log(f"aligned ATE {slam.eval_ate(label='aligned', align=True):.4f}", tag="Eval")
    if args.ate_align_scale:
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
        "mode": "sync",
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
    summary["stages"] = profiling.summary()
    with open(os.path.join(save_dir, "metrics.json"), "w") as f:
        json.dump(summary, f, indent=1)
    slam.wandb.finish()
    summary["save_dir"] = save_dir
    summary["slam"] = slam
    return summary


if __name__ == "__main__":
    main()
