"""Synthetic RGB-D sequences rendered from a ground-truth Gaussian scene
(port of monogs_tpu/data/synthetic.py).

The scene, the trajectory and therefore the best reachable ATE and PSNR
are known in closed form, so the dataset is the deterministic end-to-end
fixture. The scene and trajectory come from the same numpy draws as in the
JAX package; the ground-truth frames are rendered by the port's own
rasterizer (`ops/render.render`, backend "slab": the hand-written kernels
on a card) on the dataset's device, lazily, frame by frame.

Disk cache: a frame is a pure function of the scene, the trajectory and
the calibration, so rendered frames are kept under
<checkout>/build/synth_cache/<key>/ (MONOGS_SYNTH_CACHE_DIR overrides the
root; MONOGS_SYNTH_CACHE=0, the JAX package's switch, turns it off). The
key names the port, so a frame the JAX package rendered is never read as
the port's ground truth, even from a shared root.
"""

from __future__ import annotations

import hashlib
import os

import numpy as np
import torch

from .base import BaseDataset, cv2_for

DEFAULT_CONFIG = {
    "Dataset": {
        "type": "synthetic",
        "Calibration": {
            "width": 160, "height": 120,
            "fx": 120.0, "fy": 120.0, "cx": 80.0, "cy": 60.0,
            "depth_scale": 1.0,
        },
        "Objects": {"static": [0], "dynamic": [], "masked": []},
        "synthetic": {
            "n_frames": 30,
            "n_gaussians": 1500,
            "seed": 0,
            "motion_scale": 0.012,   # per-frame translation magnitude
        },
    },
}


def _gt_scene(n: int, seed: int):
    rng = np.random.RandomState(seed)
    # A shallow "wall" of gaussians 1.5-3.5m in front of the camera plus
    # near-field structure, guaranteeing full image coverage and parallax.
    means = np.stack(
        [
            rng.uniform(-1.6, 1.6, n),
            rng.uniform(-1.2, 1.2, n),
            rng.uniform(1.5, 3.5, n),
        ],
        axis=1,
    )
    scales = np.exp(rng.uniform(-3.4, -2.4, (n, 3)))
    quats = rng.normal(size=(n, 4)) + np.array([3.0, 0, 0, 0])
    opac = 1.0 / (1.0 + np.exp(-rng.normal(1.0, 1.0, n)))
    rgb = rng.uniform(0.05, 0.95, (n, 3))
    return means, scales, quats, opac, rgb


def _room_scene(n: int, seed: int):
    """Replica-office-like closed room: six textured box faces + interior
    clutter. Depth statistics from the orbit trajectory (below) match the
    Replica office0 profile (~0.5-4.5 m range, ~2 m median): a stand-in
    for the real sequence that needs no download."""
    rng = np.random.RandomState(seed)
    # Box half-extents: x (width), y (height, up), z (depth).
    hx, hy, hz = 3.0, 1.6, 3.0
    areas = np.array([hy * hz * 4, hy * hz * 4,   # x walls
                      hx * hz * 4, hx * hz * 4,   # floor/ceiling
                      hx * hy * 4, hx * hy * 4])  # z walls
    n_wall = int(n * 0.85)
    counts = np.maximum((areas / areas.sum() * n_wall).astype(int), 1)
    base_colors = np.array([
        [0.75, 0.70, 0.62], [0.62, 0.66, 0.72],   # warm / cool walls
        [0.45, 0.38, 0.30], [0.85, 0.85, 0.82],   # wood floor / ceiling
        [0.70, 0.72, 0.65], [0.66, 0.62, 0.70],
    ])
    pts, cols = [], []
    for face, cnt in enumerate(counts):
        # Jittered-grid sampling: near-uniform spacing keeps the face
        # watertight at sigma ~ 0.5x spacing (uniform-random placement
        # leaves ~9% pinholes at the same count).
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
        w = np.full(cnt, 1.0) + rng.normal(0, 0.01, cnt)  # small relief
        sign = 1.0 if face % 2 == 0 else -1.0
        p = np.empty((cnt, 3))
        p[:, axis] = sign * half[axis] * w
        p[:, others[0]] = u * half[others[0]]
        p[:, others[1]] = v * half[others[1]]
        pts.append(p)
        # Multi-scale procedural texture + per-splat noise: gives the
        # photometric loss structure at several frequencies (the highest
        # term survives the splat-footprint blur).
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
    # Interior clutter: furniture-scale blob clusters for parallax and
    # occlusion (tables/chairs analogue). Blobs sit ON THE FLOOR (+y is
    # down in the camera/world convention) and OUTSIDE the camera-orbit
    # annulus (_orbit_trajectory wanders within ~0.8 m of the room center;
    # a blob on the path occludes the whole view with featureless color,
    # and tracking diverges).
    n_clutter = n - sum(counts)
    n_blobs = 12
    ang = rng.uniform(0, 2 * np.pi, n_blobs)
    rad = rng.uniform(1.3, 0.85 * min(hx, hz), n_blobs)
    centers = np.stack([
        rad * np.cos(ang),
        rng.uniform(hy * 0.35, hy * 0.8, n_blobs),    # below camera height
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
    # Splat sigma ~ 0.5x mean surface spacing: 3-sigma disks still overlap
    # (near-watertight) while the screen footprint stays small enough that
    # the texture above survives (0.9x rendered to featureless mush).
    spacing = np.sqrt(areas.sum() / max(n_wall, 1))
    scales = np.exp(rng.uniform(-0.3, 0.3, (n, 3))) * spacing * 0.5
    quats = rng.normal(size=(n, 4)) + np.array([3.0, 0, 0, 0])
    opac = 1.0 / (1.0 + np.exp(-rng.normal(1.6, 0.7, n)))
    return means, scales, quats, opac, rgb


def _orbit_trajectory(n_frames: int, motion: float, seed: int = 0):
    """Indoor sweep: the camera orbits near the room center while yawing
    through ~0.9 deg/frame with small handheld pitch/roll + bob — per-frame
    motion magnitudes in the TUM fr3-office class. Returns w2c poses."""
    rng = np.random.RandomState(seed + 101)
    poses = []
    radius = 0.55
    for i in range(n_frames):
        phi = motion * i                     # yaw angle, rad
        # Camera center wanders on a circle, slight vertical bob.
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
        R_c2w = Ry @ Rx @ Rz
        R = R_c2w.T                          # w2c
        t = -R @ c
        T = np.eye(4)
        T[:3, :3] = R
        T[:3, 3] = t
        poses.append(T)
    return poses


def _trajectory(n_frames: int, motion: float):
    """Smooth sideways arc with slight rotation (w2c poses), through the
    port's se3_exp in float32."""
    from ..ops import lie

    poses = []
    for i in range(n_frames):
        s = i * motion
        theta = np.array([0.0, 0.25 * s, 0.0])
        rho = np.array([s, 0.15 * np.sin(2.0 * s), 0.05 * s])
        tau = torch.as_tensor(np.concatenate([rho, theta]), dtype=torch.float32)
        poses.append(lie.se3_exp(tau).numpy())
    return poses


# Bump when the cached frames' content or layout changes.
CACHE_SCHEMA = 1


def cache_root() -> str:
    from ..ops.kernels import BUILD_ROOT

    return os.environ.get("MONOGS_SYNTH_CACHE_DIR",
                          os.path.join(BUILD_ROOT, "synth_cache"))


class SyntheticDataset(BaseDataset):
    def __init__(self, config: dict | None = None, device="cuda"):
        if config is None:
            config = DEFAULT_CONFIG
        super().__init__(config)
        self.device = torch.device(device)
        syn = config["Dataset"].get("synthetic", DEFAULT_CONFIG["Dataset"]["synthetic"])
        self.n_frames = int(syn.get("n_frames", 30))
        self.n_gaussians = int(syn.get("n_gaussians", 1500))
        self.seed = int(syn.get("seed", 0))
        self.motion = float(syn.get("motion_scale", 0.012))
        if syn.get("scene", "wall") == "room":
            self.scene = _room_scene(self.n_gaussians, self.seed)
            self.poses = _orbit_trajectory(self.n_frames, self.motion, self.seed)
        else:
            self.scene = _gt_scene(self.n_gaussians, self.seed)
            self.poses = _trajectory(self.n_frames, self.motion)
        self.use_depth = bool(syn.get("use_depth", True))  # False = monocular
        self._tile_capacity = int(syn.get("render_tile_capacity", 256))
        # Optional moving object: a compact Gaussian blob moving at constant
        # velocity, rendered into rgb / depth and into the segmentation
        # channel as object id 1 (0 = static background). With
        # Objects.masked: [1] its pixels leave every loss; with
        # Objects.dynamic: [1] they seed obj_prob channel 1.
        dyn = syn.get("dynamic_object") or {}
        self._dyn = None
        if dyn.get("n_gaussians", 0):
            rng = np.random.RandomState(self.seed + 777)
            n_d = int(dyn["n_gaussians"])
            center = np.asarray(dyn.get("center", [0.9, 0.55, 0.9]), float)
            size = float(dyn.get("size", 0.18))
            vel = np.asarray(dyn.get("velocity", [-0.012, 0.0, -0.012]), float)
            self._dyn = {
                "means": center + rng.normal(0, size, (n_d, 3)),
                "scales": np.exp(rng.uniform(-0.2, 0.2, (n_d, 3))) * size * 0.45,
                "quats": rng.normal(size=(n_d, 4)) + np.array([3.0, 0, 0, 0]),
                "opac": 1.0 / (1.0 + np.exp(-rng.normal(2.0, 0.5, n_d))),
                "rgb": np.clip(np.array([0.85, 0.2, 0.15])
                               + rng.normal(0, 0.08, (n_d, 3)), 0.03, 0.97),
                "vel": vel,
            }
        self._cache: dict[int, dict] = {}
        c = config["Dataset"]["Calibration"]
        key_src = repr((
            "monogs_torch", CACHE_SCHEMA, syn.get("scene", "wall"), self.n_gaussians,
            self.seed, self.motion, self._tile_capacity,
            c["width"], c["height"], c["fx"], c["fy"], c["cx"], c["cy"],
            repr(sorted(dyn.items())) if self._dyn is not None else "",
        ))
        self._disk_cache = None
        if os.environ.get("MONOGS_SYNTH_CACHE", "1") == "1":
            self._disk_cache = os.path.join(
                cache_root(), hashlib.sha1(key_src.encode()).hexdigest()[:16])
            os.makedirs(self._disk_cache, exist_ok=True)

    def __len__(self):
        return self.n_frames

    def _dyn_scene(self, idx: int):
        """The moving blob at its frame-idx position."""
        d = self._dyn
        return (d["means"] + idx * d["vel"], d["scales"], d["quats"], d["opac"],
                d["rgb"])

    def _scene_at(self, idx: int):
        """(scene, obj) at frame idx: the scene to render (static, or static
        and the moving object) and the object alone (None without one)."""
        if self._dyn is None:
            return self.scene, None
        obj = self._dyn_scene(idx)
        merged = tuple(np.concatenate([np.asarray(a), np.asarray(b)], axis=0)
                       for a, b in zip(self.scene, obj))
        return merged, obj

    def _segmentation_for(self, full: dict, T: np.ndarray, obj) -> np.ndarray:
        """Object ids from an object-only render: a pixel is object 1 where
        the object covers it and its surface is not behind the composite
        front surface."""
        only = self._render_pose(T, scene=obj)
        return (only["mask"] & (only["depth"] <= full["depth"] + 0.05)).astype(np.int32)

    def _render_frame(self, idx: int) -> dict:
        if self._dyn is None:
            return self._render_pose(self.poses[idx])
        T = self.poses[idx]
        merged, obj = self._scene_at(idx)
        full = self._render_pose(T, scene=merged)
        full["segmentation"] = self._segmentation_for(full, T, obj)
        # Objects.masked is applied at read time (__getitem__), never baked
        # into the cached frame: the cache key leaves the Objects config out.
        return full

    def _render_pose(self, T: np.ndarray, scene=None) -> dict:
        """Render the scene (or an override scene tuple) from a w2c pose on
        the dataset's device; one host read of the images."""
        from ..ops.render import render
        from ..utils.logging import Log

        f32, dev = torch.float32, self.device
        means, scales, quats, opac, rgb = (
            torch.as_tensor(np.asarray(x), dtype=f32, device=dev)
            for x in (scene or self.scene))
        out = render(means, scales, quats, opac, rgb,
                     torch.as_tensor(T[:3, :3], dtype=f32, device=dev),
                     torch.as_tensor(T[:3, 3], dtype=f32, device=dev),
                     self.intrinsics, tile_capacity=self._tile_capacity, max_dup=32)
        host = torch.cat([out.rgb.reshape(-1), out.depth.reshape(-1),
                          out.opacity.reshape(-1), out.overflow.to(f32)[None]]).cpu().numpy()
        H, W = self.height, self.width
        rgb_np = host[:H * W * 3].reshape(H, W, 3)
        depth_raw = host[H * W * 3:H * W * 4].reshape(H, W)
        opacity = host[H * W * 4:H * W * 5].reshape(H, W)
        if int(host[-1]):
            Log(f"synthetic GT render dropped {int(host[-1])} entries "
                f"(raise Dataset.synthetic.render_tile_capacity)", tag="System")
        covered = opacity > 0.5
        depth = np.where(covered, depth_raw / np.maximum(opacity, 1e-6), 0.0)
        return {
            "rgb": np.clip(rgb_np, 0.0, 1.0).astype(np.float32),
            "depth": depth.astype(np.float32),
            "pose": T.astype(np.float32),  # w2c
            "mask": covered,
            "segmentation": np.zeros(depth.shape, np.int32),
        }

    def _load_or_render(self, idx: int) -> dict:
        if self._disk_cache is None:
            return self._render_frame(idx)
        path = os.path.join(self._disk_cache, f"frame_{idx:05d}.npz")
        if os.path.exists(path):
            z = np.load(path)
            return {"rgb": z["rgb"], "depth": z["depth"],
                    "pose": self.poses[idx].astype(np.float32), "mask": z["mask"],
                    "segmentation": z["segmentation"]}
        d = self._render_frame(idx)
        tmp = path + f".tmp{os.getpid()}"
        with open(tmp, "wb") as f:  # a handle: savez must not append .npz
            np.savez(f, rgb=d["rgb"], depth=d["depth"], mask=d["mask"],
                     segmentation=d["segmentation"])
        os.replace(tmp, path)
        return d

    def __getitem__(self, idx: int) -> dict:
        if idx not in self._cache:
            self._cache[idx] = self._load_or_render(idx)
        d = self._cache[idx]
        if self.masked_objects_idxs:
            # The config's loss mask, from the cached segmentation.
            d = dict(d, mask=d["mask"] & self.mask_from_segmentation(d["segmentation"]))
        if not self.use_depth:
            d = dict(d, depth=None)
        return d


class SyntheticStereoDataset(SyntheticDataset):
    """The stereo sensor over the synthetic scene (port of the JAX
    package's SyntheticStereoDataset): a rectified cam0 / cam1 pair a frame,
    cam1 the left camera moved `baseline` metres along its +x axis, both
    rendered by the port's rasterizer on the dataset's device (the slab
    kernels on a card), then the EuRoC host pipeline through OpenCV:
    initUndistortRectifyMap per camera (a distortion-free rig, so the remap
    is the identity warp, on the code path a distorted rig takes), remap,
    SGBM disparity, depth = fx * baseline / disparity. The depth the SLAM
    sees is SGBM's estimate, never the rendered depth. Without OpenCV the
    constructor raises ImportError."""

    def __init__(self, config: dict | None = None, device="cuda"):
        super().__init__(config, device=device)
        syn = (config or DEFAULT_CONFIG)["Dataset"].get(
            "synthetic", DEFAULT_CONFIG["Dataset"]["synthetic"])
        st = syn.get("stereo", {})
        self.baseline = float(st.get("baseline", 0.08))
        self.num_disparities = int(st.get("num_disparities", 128))
        self.sgbm_block_size = int(st.get("block_size", 11))
        self.uniqueness = int(st.get("uniqueness_ratio", 10))
        # Right-camera w2c: x_right = x_left - (b, 0, 0) in camera coordinates.
        self._T_lr = np.eye(4, dtype=np.float64)
        self._T_lr[0, 3] = -self.baseline
        self._maps = self._rectify_maps()
        # A cache directory of its own: the frames depend on the stereo
        # parameters too (the parent key covers scene, trajectory, calibration).
        if self._disk_cache is not None:
            tag = hashlib.sha1(repr((
                "stereo", 1, self.baseline, self.num_disparities, self.sgbm_block_size,
                self.uniqueness)).encode()).hexdigest()[:12]
            self._disk_cache = self._disk_cache + "-st" + tag
            os.makedirs(self._disk_cache, exist_ok=True)

    def _rectify_maps(self):
        """Zero distortion, R = identity, K_new = K: OpenCV's rectification
        on the path a distorted rig takes."""
        cv2 = cv2_for("the stereo synthetic rig (rectification and SGBM depth)")
        K = np.array([[self.intrinsics.fx, 0.0, self.intrinsics.cx],
                      [0.0, self.intrinsics.fy, self.intrinsics.cy], [0.0, 0.0, 1.0]])
        size = (self.intrinsics.width, self.intrinsics.height)
        return tuple(cv2.initUndistortRectifyMap(K, np.zeros(5), np.eye(3), K, size,
                                                 cv2.CV_32FC1) for _ in range(2))

    def _render_frame(self, idx: int) -> dict:
        cv2 = cv2_for("the stereo synthetic rig (rectification and SGBM depth)")
        T_l = self.poses[idx]
        T_r = self._T_lr @ T_l
        # Both eyes render the same scene of the frame, the moving object too.
        scene, obj = self._scene_at(idx)
        left = self._render_pose(T_l, scene=scene)
        right = self._render_pose(T_r, scene=scene)
        m_l, m_r = self._maps

        g_l = (np.clip(left["rgb"], 0, 1) * 255).astype(np.uint8)
        g_r = (np.clip(right["rgb"], 0, 1) * 255).astype(np.uint8)
        g_l = cv2.remap(cv2.cvtColor(g_l, cv2.COLOR_RGB2GRAY), *m_l, cv2.INTER_LINEAR)
        g_r = cv2.remap(cv2.cvtColor(g_r, cv2.COLOR_RGB2GRAY), *m_r, cv2.INTER_LINEAR)

        # SGBM, numDisparities sized for the room's near field (the least
        # depth is fx * b / numDisparities).
        sgbm = cv2.StereoSGBM_create(minDisparity=0, numDisparities=self.num_disparities,
                                     blockSize=self.sgbm_block_size)
        sgbm.setUniquenessRatio(self.uniqueness)
        disp = sgbm.compute(g_l, g_r).astype(np.float32) / 16.0
        valid = disp > 0.0
        bf = self.intrinsics.fx * self.baseline
        depth = np.where(valid, bf / np.maximum(disp, 1e-6), 0.0)
        # Matches beyond the scene's range (tiny disparities) are outliers.
        depth = np.where(depth < 100.0, depth, 0.0)
        valid = depth > 0.0

        seg = (np.zeros(depth.shape, np.int32) if obj is None
               else self._segmentation_for(left, T_l, obj))
        return {
            "rgb": left["rgb"],
            "depth": depth.astype(np.float32),
            "pose": T_l.astype(np.float32),
            "mask": valid & left["mask"],
            "segmentation": seg,
        }
