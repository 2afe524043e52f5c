"""Config loading and the typed run configs (port of
monogs_tpu/utils/config.py).

`load_config` reads a YAML file with `yaml.safe_load` and deep-merges it
over the file its `inherit_from` names, recursively. The `build_*_config`
functions read the merged dict into the frozen configs the tracker, the
mapper, the keyframe logic and the system take, with the JAX package's
defaults.

Backend names: the YAML files and the JAX package say "pallas" for the
production rasterizer; the port calls it "slab" (the hand-written kernels
on a card, their plain twins on the CPU). `port_backend` is the one place
that translates, and it refuses any other name, so no misspelt backend
silently selects the dense oracle.
"""

from __future__ import annotations

import dataclasses

import yaml

from .logging import Log

BACKENDS = ("ref", "slab")


def port_backend(name: str) -> str:
    """The port's backend for a config's name: "pallas" -> "slab"; "ref"
    and "slab" as they are; anything else raises ValueError."""
    if name == "pallas":
        return "slab"
    if name not in BACKENDS:
        raise ValueError(f"unknown rasterizer backend {name!r}: the port has "
                         f"{BACKENDS} ('pallas' in a config means 'slab')")
    return name


def update_recursive(dict1: dict, dict2: dict):
    """Deep-merge dict2 into dict1."""
    for k, v in dict2.items():
        if k not in dict1:
            dict1[k] = {}
        if isinstance(v, dict):
            update_recursive(dict1[k], v)
        else:
            dict1[k] = v


def load_config(path: str, default_path: str | None = None) -> dict:
    """Load a YAML config, recursively resolving inherit_from (a path
    relative to the working directory, as the configs give it)."""
    with open(path) as f:
        cfg_special = yaml.safe_load(f)

    inherit = cfg_special.get("inherit_from")
    if inherit is not None:
        cfg = load_config(inherit, default_path)
    elif default_path is not None:
        with open(default_path) as f:
            cfg = yaml.safe_load(f)
    else:
        cfg = {}
    update_recursive(cfg, cfg_special)
    return cfg


def _get(cfg: dict, *path, default=None):
    cur = cfg
    for p in path:
        if not isinstance(cur, dict) or p not in cur:
            return default
        cur = cur[p]
    return cur


def build_tracker_config(cfg: dict, backend: str = "slab"):
    from ..slam.tracker import TrackerConfig

    g = lambda *p, d=None: _get(cfg, *p, default=d)
    return TrackerConfig(
        max_iters=g("Training", "tracking_itr_num", d=100),
        lr_rot=g("Training", "lr", "cam_rot_delta", d=0.003),
        lr_trans=g("Training", "lr", "cam_trans_delta", d=0.001),
        tile_size=g("Raster", "tile_size", d=32),
        tile_capacity=g("Raster", "tracking_tile_capacity", d=2048),
        max_dup=g("Raster", "max_dup", d=4),
        max_dup_gen=g("Raster", "max_dup_gen", d=16),
        entry_capacity=g("Raster", "tracking_entry_capacity", d=None),
        cull_alpha=g("Raster", "cull_alpha", d=1.0 / 255.0),
        backend=port_backend(backend),
        isotropic=g("Gaussians", "isotropic", d=False),
        const_velocity=g("Training", "const_velocity", d=False),
        exposure_reg=g("Training", "exposure_reg", d=0.0),
    )


def build_mapper_config(cfg: dict, backend: str = "slab"):
    """The MapperConfig of a merged config."""
    from ..slam.mapper import MapperConfig

    g = lambda *p, d=None: _get(cfg, *p, default=d)
    return MapperConfig(
        init_itr_num=g("Training", "init_itr_num", d=1050),
        init_gaussian_update=g("Training", "init_gaussian_update", d=100),
        init_gaussian_reset=g("Training", "init_gaussian_reset", d=500),
        init_gaussian_th=g("Training", "init_gaussian_th", d=0.005),
        init_gaussian_extent=g("Training", "init_gaussian_extent", d=30.0),
        iters_per_kf=g("Training", "mapping_itr_num", d=300),
        gaussian_update_every=g("Training", "gaussian_update_every", d=150),
        gaussian_update_offset=g("Training", "gaussian_update_offset", d=50),
        gaussian_th=g("Training", "gaussian_th", d=0.7),
        gaussian_extent=g("Training", "gaussian_extent", d=1.0),
        gaussian_reset=g("Training", "gaussian_reset", d=2001),
        size_threshold=g("Training", "size_threshold", d=20.0),
        prune_coviz=_safe_prune_coviz(
            g("Training", "prune_coviz", d=3),
            g("Training", "window_size", d=8),
        ),
        densify_grad_threshold=g("opt_params", "densify_grad_threshold", d=2e-4),
        percent_dense=g("opt_params", "percent_dense", d=0.01),
        position_lr_init=g("opt_params", "position_lr_init", d=1.6e-3),
        position_lr_final=g("opt_params", "position_lr_final", d=1.6e-6),
        position_lr_delay_mult=g("opt_params", "position_lr_delay_mult", d=0.01),
        position_lr_max_steps=g("opt_params", "position_lr_max_steps", d=30000),
        feature_lr=g("opt_params", "feature_lr", d=2.5e-3),
        opacity_lr=g("opt_params", "opacity_lr", d=0.05),
        scaling_lr=g("opt_params", "scaling_lr", d=1e-3),
        rotation_lr=g("opt_params", "rotation_lr", d=1e-3),
        lr_rot=g("Training", "lr", "cam_rot_delta", d=0.003) * 0.5,
        lr_trans=g("Training", "lr", "cam_trans_delta", d=0.001) * 0.5,
        lambda_ssim=g("opt_params", "lambda_ssim", d=0.2),
        tile_size=g("Raster", "tile_size", d=32),
        tile_capacity=g("Raster", "tile_capacity", d=1024),
        max_dup=g("Raster", "max_dup", d=4),
        max_dup_gen=g("Raster", "max_dup_gen", d=16),
        entry_capacity=g("Raster", "entry_capacity", d=None),
        cull_alpha=g("Raster", "cull_alpha", d=1.0 / 255.0),
        backend=port_backend(backend),
        isotropic=g("Gaussians", "isotropic", d=False),
        isotropic_loss_weight=g("Training", "isotropic_loss_weight", d=0.0),
        refine_colors_only=g("Training", "refine_colors_only", d=True),
        converged_eps=g("Training", "mapping_converged_eps", d=0.0),
        lambda_depth=g("Training", "lambda_depth", d=0.9),
        converged_patience=g("Training", "mapping_converged_patience", d=4),
        exposure_reg=g("Training", "exposure_reg", d=0.0),
        monocular=g("Dataset", "sensor_type", d="depth") == "monocular"
        and not g("Dataset", "Calibration", "use_depth", d=False),
        # Opt-in: seeding sensor-depth dropout holes with synthesized depth
        # corrupted stereo maps as a default (monogs_tpu/utils/config.py).
        fill_depth_dropout=g("Dataset", "fill_depth_dropout", d=False),
        pcd_downsample_init=g("Dataset", "pcd_downsample_init", d=32),
        pcd_downsample=g("Dataset", "pcd_downsample", d=64),
        point_size=g("Dataset", "point_size", d=0.01),
    )


def _safe_prune_coviz(prune_coviz: int, window_size: int) -> int:
    """The covisibility prune removes Gaussians seen by at most prune_coviz
    window keyframes; with window_size <= prune_coviz that holds for every
    Gaussian and wipes the map. Clamp and warn."""
    if window_size <= prune_coviz:
        safe = max(window_size - 2, 1)
        Log(f"prune_coviz {prune_coviz} >= window_size {window_size} would "
            f"prune every Gaussian; clamping to {safe}", tag="System")
        return safe
    return prune_coviz


def build_keyframe_config(cfg: dict):
    from ..slam.keyframes import KeyframeConfig

    g = lambda *p, d=None: _get(cfg, *p, default=d)
    return KeyframeConfig(
        kf_translation=g("Training", "kf_translation", d=0.08),
        kf_min_translation=g("Training", "kf_min_translation", d=0.05),
        kf_overlap=g("Training", "kf_overlap", d=0.9),
        kf_cutoff=g("Training", "kf_cutoff", d=0.3),
        window_size=g("Training", "window_size", d=8),
        kf_interval=g("Training", "kf_interval", d=1),
        check_viewpoints_overlap=g("Training", "check_viewpoints_overlap", d=False),
    )


@dataclasses.dataclass
class SystemConfig:
    """Top-level run options."""

    map_capacity: int = 1 << 17
    capacity_headroom: int = 8192   # grow when free slots drop below this
    seed: int = 0
    save_dir: str | None = None
    eval_every: int = 10            # ATE every N frames (Results.save_trj_kf_intv)
    backend: str = "slab"
    # Load frame idx+1 on a host thread while frame idx is processed.
    prefetch: bool = True
    use_wandb: bool = False
    # True: the synchronous path; False: the tracker and the mapper run
    # concurrently (SLAM.run_async), as the reference's default topology.
    single_thread: bool = True
    ckpt_every: int = 0             # checkpoint every N keyframes (0 = off)
    # Async mode: the first N keyframe events run synchronously (the
    # tracker waits for each mapper result before tracking on), so tracking
    # does not run against the stale snapshot of a young map. 0 = off, as
    # the reference overlaps from frame 0.
    async_bootstrap_kfs: int = 0
    # Ranks of the window mesh (parallel/mesh.py): the mapper's keyframe
    # window shards over a process group of this size; 0 = unsharded.
    mesh_devices: int = 0


def build_system_config(cfg: dict) -> SystemConfig:
    g = lambda *p, d=None: _get(cfg, *p, default=d)
    return SystemConfig(
        map_capacity=g("System", "map_capacity", d=1 << 17),
        capacity_headroom=g("System", "capacity_headroom", d=8192),
        seed=g("System", "seed", d=0),
        save_dir=g("Results", "save_dir", d=None),
        eval_every=g("Results", "save_trj_kf_intv", d=10),
        backend=port_backend(g("System", "backend", d="slab")),
        prefetch=g("System", "prefetch", d=True),
        use_wandb=g("Results", "use_wandb", d=False),
        # Dataset.single_thread (scene yaml) overrides Training.single_thread
        # (base yaml), as in the JAX package.
        single_thread=g("Dataset", "single_thread",
                        d=g("Training", "single_thread", d=True)),
        ckpt_every=g("System", "ckpt_every", d=0),
        async_bootstrap_kfs=g("System", "async_bootstrap_kfs", d=0),
        mesh_devices=g("System", "mesh_devices", d=0),
    )
