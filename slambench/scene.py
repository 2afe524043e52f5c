"""The synthetic room and its camera orbit, frozen.

A copy of the room draws of `monogs_torch/data/synthetic.py`
(`_room_scene`, `_orbit_trajectory`) as they stood when this benchmark was
defined, so that a later edit of the program cannot move the benchmark's
inputs. `tests/test_slambench_scene.py` holds the copy against the program's
draws at a small size. The frames are rendered from this scene by the plain
renderer in `reference/render.py`, never by the program's kernels.
"""

from __future__ import annotations

import numpy as np

SEED_MOD = 2 ** 32 - 1024  # numpy's RandomState takes seeds below 2**32


def numpy_seed(seed: int) -> int:
    """A --seed (any non-negative integer) as a RandomState seed."""
    return int(seed) % SEED_MOD


def room_scene(n: int, seed: int):
    """The closed textured room: six jittered-grid box faces and floor
    clutter. -> (means (n, 3), scales (n, 3) activated, quats (n, 4) wxyz,
    opacities (n,) activated, rgb (n, 3)), float64 numpy."""
    rng = np.random.RandomState(seed)
    hx, hy, hz = 3.0, 1.6, 3.0
    areas = np.array([hy * hz * 4, hy * hz * 4,
                      hx * hz * 4, hx * hz * 4,
                      hx * hy * 4, hx * hy * 4])
    n_wall = int(n * 0.85)
    counts = np.maximum((areas / areas.sum() * n_wall).astype(int), 1)
    base_colors = np.array([
        [0.75, 0.70, 0.62], [0.62, 0.66, 0.72],
        [0.45, 0.38, 0.30], [0.85, 0.85, 0.82],
        [0.70, 0.72, 0.65], [0.66, 0.62, 0.70],
    ])
    pts, cols = [], []
    for face, cnt in enumerate(counts):
        half = [hx, hy, hz]
        axis = face // 2
        others = [a for a in range(3) if a != axis]
        aspect = half[others[0]] / half[others[1]]
        nu = max(int(np.ceil(np.sqrt(cnt * aspect))), 1)
        nv = max(int(np.ceil(cnt / nu)), 1)
        gu, gv = np.meshgrid(
            (np.arange(nu) + 0.5) / nu * 2 - 1,
            (np.arange(nv) + 0.5) / nv * 2 - 1,
        )
        keep = rng.permutation(nu * nv)[:cnt]
        u = gu.ravel()[keep] + rng.uniform(-0.5, 0.5, cnt) / nu
        v = gv.ravel()[keep] + rng.uniform(-0.5, 0.5, cnt) / nv
        w = np.full(cnt, 1.0) + rng.normal(0, 0.01, cnt)
        sign = 1.0 if face % 2 == 0 else -1.0
        p = np.empty((cnt, 3))
        p[:, axis] = sign * half[axis] * w
        p[:, others[0]] = u * half[others[0]]
        p[:, others[1]] = v * half[others[1]]
        pts.append(p)
        tex = (
            0.18 * np.sin(3.1 * u + 1.7 * face)[:, None]
            + 0.14 * np.cos(4.3 * v - 0.9 * face)[:, None]
            + 0.08 * np.sin(9.7 * u * v)[:, None]
            + 0.10 * np.sin(23.0 * u + 1.3 * face)[:, None]
            + 0.08 * np.cos(17.0 * v + 2.1 * face)[:, None]
        )
        c = np.clip(base_colors[face] + tex + rng.normal(0, 0.07, (cnt, 3)),
                    0.03, 0.97)
        cols.append(c)
    n_clutter = n - sum(counts)
    n_blobs = 12
    ang = rng.uniform(0, 2 * np.pi, n_blobs)
    rad = rng.uniform(1.3, 0.85 * min(hx, hz), n_blobs)
    centers = np.stack([
        rad * np.cos(ang),
        rng.uniform(hy * 0.35, hy * 0.8, n_blobs),
        rad * np.sin(ang),
    ], axis=1)
    blob_col = rng.uniform(0.1, 0.9, (n_blobs, 3))
    blob_of = rng.randint(0, n_blobs, n_clutter)
    p = centers[blob_of] + rng.normal(0, 0.12, (n_clutter, 3))
    pts.append(p)
    cols.append(np.clip(
        blob_col[blob_of] + rng.normal(0, 0.07, (n_clutter, 3)), 0.03, 0.97
    ))
    means = np.concatenate(pts, axis=0)
    rgb = np.concatenate(cols, axis=0)
    spacing = np.sqrt(areas.sum() / max(n_wall, 1))
    scales = np.exp(rng.uniform(-0.3, 0.3, (n, 3))) * spacing * 0.5
    quats = rng.normal(size=(n, 4)) + np.array([3.0, 0, 0, 0])
    opac = 1.0 / (1.0 + np.exp(-rng.normal(1.6, 0.7, n)))
    return means, scales, quats, opac, rgb


def orbit_trajectory(n_frames: int, motion: float) -> list:
    """The indoor sweep round the room's centre with handheld pitch, roll
    and bob: n_frames (4, 4) world-to-camera poses, float64. It draws no
    random numbers, so every seed sees the same camera path."""
    poses = []
    radius = 0.55
    for i in range(n_frames):
        phi = motion * i
        c = np.array([
            radius * np.sin(phi),
            0.12 * np.sin(2.3 * phi) + 0.1,
            -radius * 0.4 * np.cos(phi),
        ])
        yaw = phi + 0.2 * np.sin(0.7 * phi)
        pitch = 0.06 * np.sin(1.9 * phi)
        roll = 0.03 * np.sin(2.7 * phi)
        cy, sy = np.cos(yaw), np.sin(yaw)
        cp, sp = np.cos(pitch), np.sin(pitch)
        cr, sr = np.cos(roll), np.sin(roll)
        Ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
        Rx = np.array([[1, 0, 0], [0, cp, -sp], [0, sp, cp]])
        Rz = np.array([[cr, -sr, 0], [sr, cr, 0], [0, 0, 1]])
        R = (Ry @ Rx @ Rz).T
        T = np.eye(4)
        T[:3, :3] = R
        T[:3, 3] = -R @ c
        poses.append(T)
    return poses
