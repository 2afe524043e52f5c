"""Write a synthetic sequence in the TUM RGB-D on-disk layout (the port of
scripts/make_tum_fixture.py), so that the TUM parser's whole path (stamped
tables, nearest-timestamp association, 32 Hz thinning, c2w quaternion
poses, 16-bit depth / 5000) runs at full scale without a download:

    <out>/rgb/<stamp>.png          8-bit RGB
    <out>/depth/<stamp>.png        16-bit gray, depth * 5000 (TUM's scale)
    <out>/rgb.txt, depth.txt       a '# comment' header, then 'stamp path' rows
    <out>/groundtruth.txt          a header, then 'stamp tx ty tz qx qy qz qw'
                                   (c2w, TUM's quaternion order)

The streams are not aligned, as on the real sensor logs: rgb at 30 Hz with
+-3 ms of jitter, depth 11 ms later with its own jitter, ground truth at
about 90 Hz, the same draws of default_rng(7) in the same order as the
JAX package's script. The images are encoded by the port's own PNG writer
(`utils/images.py`), so this runs where OpenCV is missing.

    python -m monogs_torch.tools.make_tum_fixture [out_dir] [--config CFG]
        [--n-frames N] [--device cpu]

defaults: configs/synthetic/room_final.yaml's room, every frame, into
configs/rgbd/tum/room_fixture.yaml's dataset_path, ground truth rendered on
the card. Then: python -m monogs_torch --config configs/rgbd/tum/room_fixture.yaml
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np

DEPTH_SCALE = 5000.0
DEFAULT_CONFIG = "configs/synthetic/room_final.yaml"
FIXTURE_CONFIG = "configs/rgbd/tum/room_fixture.yaml"


def rot_to_quat(R):
    """(3, 3) -> (qx, qy, qz, qw), TUM's ground-truth order."""
    w = np.sqrt(max(0.0, 1.0 + R[0, 0] + R[1, 1] + R[2, 2])) / 2.0
    if w > 1e-6:
        x = (R[2, 1] - R[1, 2]) / (4 * w)
        y = (R[0, 2] - R[2, 0]) / (4 * w)
        z = (R[1, 0] - R[0, 1]) / (4 * w)
    else:  # a rotation by about 180 degrees
        i = int(np.argmax(np.diag(R)))
        j, k = (i + 1) % 3, (i + 2) % 3
        s = np.sqrt(max(0.0, 1.0 + R[i, i] - R[j, j] - R[k, k])) * 2
        q = np.zeros(4)
        q[i] = s / 4
        q[j] = (R[j, i] + R[i, j]) / s
        q[k] = (R[k, i] + R[i, k]) / s
        x, y, z = q[:3]
        w = (R[k, j] - R[j, k]) / s
    return x, y, z, w


def quantise(frame: dict) -> tuple[np.ndarray, np.ndarray]:
    """A frame's rgb and depth as the fixture stores them: uint8 RGB
    (truncated from [0, 1] * 255) and uint16 depth * 5000."""
    rgb = (np.clip(frame["rgb"], 0, 1) * 255).astype(np.uint8)
    depth = np.clip(frame["depth"] * DEPTH_SCALE, 0, 65535).astype(np.uint16)
    return rgb, depth


def write_tum_fixture(dataset, out_dir: str, n_frames: int | None = None) -> dict:
    """Write the first `n_frames` frames of `dataset` (every frame by
    default) in the TUM layout under out_dir. -> {"frames", "bytes",
    "encode_s" (the PNG encodes and writes alone), "render_s" (the frames'
    loads), "filters" (rows of each filter type over every image)}."""
    from ..utils.images import FILTER_NAMES, write_png

    n = len(dataset) if n_frames is None else min(int(n_frames), len(dataset))
    os.makedirs(os.path.join(out_dir, "rgb"), exist_ok=True)
    os.makedirs(os.path.join(out_dir, "depth"), exist_ok=True)
    rng = np.random.default_rng(7)
    t0 = 1341840000.0  # an fr3-era epoch; arbitrary
    rgb_rows, depth_rows, gt_rows = [], [], []
    filters = np.zeros(len(FILTER_NAMES), np.int64)
    encode_s = render_s = 0.0
    for i in range(n):
        tic = time.perf_counter()
        d = dataset[i]
        render_s += time.perf_counter() - tic
        t_rgb = t0 + i / 30.0 + rng.uniform(-0.003, 0.003)
        t_dep = t0 + i / 30.0 + 0.011 + rng.uniform(-0.003, 0.003)
        rgb_name = f"rgb/{t_rgb:.6f}.png"
        dep_name = f"depth/{t_dep:.6f}.png"
        rgb8, dep16 = quantise(d)
        tic = time.perf_counter()
        for name, img in ((rgb_name, rgb8), (dep_name, dep16)):
            filters += np.bincount(write_png(os.path.join(out_dir, name), img),
                                   minlength=len(FILTER_NAMES))
        encode_s += time.perf_counter() - tic
        rgb_rows.append(f"{t_rgb:.6f} {rgb_name}")
        depth_rows.append(f"{t_dep:.6f} {dep_name}")

        # c2w ground truth at about 3 samples a frame: each sample carries
        # the frame's pose, at stamps around the rgb stamp, so the
        # association must pick the nearest.
        T = d["pose"]  # w2c
        Rc2w = T[:3, :3].T
        tc2w = -Rc2w @ T[:3, 3]
        qx, qy, qz, qw = rot_to_quat(Rc2w)
        for k in (-1, 0, 1):
            tg = t_rgb + k * 0.0111 + rng.uniform(-0.001, 0.001)
            gt_rows.append(f"{tg:.6f} {tc2w[0]:.6f} {tc2w[1]:.6f} {tc2w[2]:.6f} "
                           f"{qx:.6f} {qy:.6f} {qz:.6f} {qw:.6f}")
        if (i + 1) % 25 == 0:
            print(f"  {i + 1}/{n}")

    with open(os.path.join(out_dir, "rgb.txt"), "w") as f:
        f.write("# color images\n" + "\n".join(rgb_rows) + "\n")
    with open(os.path.join(out_dir, "depth.txt"), "w") as f:
        f.write("# depth images\n" + "\n".join(depth_rows) + "\n")
    with open(os.path.join(out_dir, "groundtruth.txt"), "w") as f:
        f.write("# ground truth trajectory\n" + "\n".join(sorted(gt_rows)) + "\n")
    nbytes = sum(os.path.getsize(os.path.join(r, f))
                 for r, _, fs in os.walk(out_dir) for f in fs)
    return {"frames": n, "bytes": nbytes, "encode_s": encode_s, "render_s": render_s,
            "filters": dict(zip(FILTER_NAMES, filters.tolist()))}


def main(argv: list[str] | None = None) -> dict:
    from ..data import load_dataset
    from ..utils.config import load_config

    ap = argparse.ArgumentParser(prog="python -m monogs_torch.tools.make_tum_fixture",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("out_dir", nargs="?", default=None,
                    help=f"output directory (default: {FIXTURE_CONFIG}'s dataset_path)")
    ap.add_argument("--config", default=DEFAULT_CONFIG,
                    help="the synthetic config whose frames are written")
    ap.add_argument("--n-frames", type=int, default=None, help="write only the first N")
    ap.add_argument("--device", default="cuda",
                    help="where the ground truth renders (default cuda)")
    args = ap.parse_args(argv)
    out = args.out_dir or os.path.expanduser(
        load_config(FIXTURE_CONFIG)["Dataset"]["dataset_path"])
    ds = load_dataset(load_config(args.config), device=args.device)
    n = len(ds) if args.n_frames is None else min(args.n_frames, len(ds))
    print(f"{args.config}: {n} frames -> {out}")
    stats = write_tum_fixture(ds, out, n)
    print(f"fixture complete: {stats}")
    return stats


if __name__ == "__main__":
    main()
