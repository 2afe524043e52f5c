"""The SLAM system (port of monogs_tpu/slam/system.py).

`run` is the reference's deterministic single-thread configuration: each
frame is loaded (the next one on a host thread meanwhile), tracked against
the current map, and, when it becomes a keyframe, the mapper extends the
map from it, optimises the keyframe window and prunes. `run_async` runs
the tracker and the mapper concurrently, the reference's default
topology, on two host threads (see its docstring). Everything runs on the
SLAM `device` (default "cuda"): a CUDA device runs the hand-written
kernels; the CPU runs their plain twins and is for tests. Nothing moves to
the CPU on its own.

After the frame loop, `refine` refines the map's colours over the
keyframes. With `SystemConfig.ckpt_every` and a save_dir, both loops
checkpoint the whole state every N keyframes (utils/ckpt.py), and
`run(start_frame=...)` / `run_async(start_frame=...)` continue a restored
run.

Host reads, as in the JAX package: one (22,) `host_stats` read per
tracked frame (the tracker's convergence exit reads one bool per
iteration besides), one read of `window_host_pack` per keyframe, and in
`refine` one overflow read every 200 iterations and one at the end.

`start_viewer` serves the live web viewer (viewer/server.py), which the
frame loops feed a packet every tracked frame and which pauses them. With
SystemConfig.mesh_devices the mapper's window shards over the ranks of a
process group (parallel/): every rank runs this frame loop on the
same stream, and the mapping spans run sharded, the rest replicated.

Not carried over from the JAX package: the background compiles of
`prewarm` and the demand re-probes (eager PyTorch has no compile step: a
re-probe adopts a larger entry capacity at once, and `prewarm` builds the
CUDA kernels), and `_place_state` (the state stays whole between mapping
spans; each span takes its rank's share and gathers it back).
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import os
import queue
import random
import threading
import time

import numpy as np
import torch

from ..models import gaussian_map as gm
from ..ops.binning import SLAB, auto_entry_capacity, measure_entry_demand
from ..ops.projection import project_gaussians_ch
from ..ops.render import render
from ..utils.ckpt import save_checkpoint, state_tensors
from ..utils.config import (
    SystemConfig,
    build_keyframe_config,
    build_mapper_config,
    build_system_config,
    build_tracker_config,
)
from ..utils.eval import eval_rendering, eval_traj_ate
from ..utils.logging import Log, WandbLogger
from ..utils.ply import save_ply
from ..utils.profiling import section
from . import keyframes as kf
from .camera import Frame, make_frame, window_from_list, window_update
from .mapper import (
    MapperState,
    covisibility_prune,
    extend_event,
    init_mapper_state,
    init_pose_adam,
    refine_chunk,
    refine_span,
    refine_step,
    run_initialize_map,
    run_optimize_map,
    unpack_window_host,
    visibility_pass,
    window_host_pack,
)
from .tracker import track_frame, unpack_host_stats


class _FramePrefetcher:
    """Single-worker lookahead: while frame idx is tracked and mapped,
    frame idx+1 is loaded (dataset read, host-to-device copy) on a host
    thread. Random access falls through to a synchronous load."""

    def __init__(self, load_fn):
        self._load = load_fn
        self._pending: dict[int, concurrent.futures.Future] = {}
        self._ex = concurrent.futures.ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="frame-prefetch")

    def get(self, idx: int):
        fut = self._pending.pop(idx, None)
        frame = fut.result() if fut is not None else self._load(idx)
        if idx + 1 not in self._pending:
            # Bound the stale lookaheads random access leaves behind.
            while len(self._pending) >= 4:
                self._pending.pop(next(iter(self._pending))).result()
            self._pending[idx + 1] = self._ex.submit(self._guarded, idx + 1)
        return frame

    def _guarded(self, idx: int):
        try:
            return self._load(idx)
        except (IndexError, KeyError):  # past the end of the dataset
            return None


def const_velocity_init(prev: tuple, prev2: tuple, base: tuple | None = None) -> tuple:
    """SE(3) constant-velocity extrapolation on numpy w2c (R, t) pairs:
    T_init = (T_prev T_prev2^-1) T_base.

    The velocity must come from the tracker's raw per-frame poses: the
    mapper overwrites keyframe poses in est_poses, and a velocity from a
    refined prev and an unrefined prev2 counts the correction twice. `base`
    is the best current estimate of the previous pose (default prev)."""
    prev_R, prev_t = prev
    R2, t2 = prev2
    R_rel = prev_R @ R2.T
    t_rel = prev_t - R_rel @ t2
    base_R, base_t = base if base is not None else prev
    return R_rel @ base_R, R_rel @ base_t + t_rel


class SLAM:
    # Slab rows per pixel, with headroom: the slab's occupancy is bounded
    # by the screen (about 0.4 rows a pixel once the map is dense), so the
    # derived capacity is max(1.25x the first frame's padded demand, this
    # bound), with the overflow bump as the backstop. The JAX package also
    # snaps capacities under a gather-memory cliff it measured on its TPU;
    # that cliff is a TPU memory size and has no counterpart here.
    ENTRY_DENSITY = 0.7
    # Frames between the tracker's demand re-probes (keyframes: 8).
    REPROBE_EVERY = 25

    def __init__(self, dataset, config: dict | None = None, tracker_config=None,
                 mapper_config=None, keyframe_config=None,
                 system_config: SystemConfig | None = None, device="cuda"):
        config = config or {}
        self.device = torch.device(device)
        self.dataset = dataset
        self.intr = dataset.intrinsics
        self.tcfg = tracker_config or build_tracker_config(config)
        self.mcfg = mapper_config or build_mapper_config(config)
        self.kcfg = keyframe_config or build_keyframe_config(config)
        self.scfg = system_config or build_system_config(config)

        self.est_poses: dict[int, tuple] = {}    # idx -> numpy (R, t) w2c
        # Raw tracker outputs, never overwritten by the mapper: the
        # constant-velocity source (see const_velocity_init).
        self._raw_poses: dict[int, tuple] = {}
        self.exposures: dict[int, tuple] = {}    # idx -> (a, b)
        self.gt_poses: dict[int, tuple] = {}
        self.frames: dict[int, Frame] = {}       # window + the newest frame
        self.vis_dict: dict[int, torch.Tensor] = {}
        self.kf_list: list[int] = []
        self.kf_history: set[int] = set()        # every index made a keyframe
        # Keyframe index per slot of the current state.window, so a keyframe
        # event builds the next window on the device by permutation.
        self._window_slots: list[int] | None = None
        self.is_window_full = False
        self.first_time_pruned = False
        self.median_depth = 1.0
        self.state: MapperState | None = None
        # The mapper's overflow reads: one per keyframe event (sync), one
        # per span while the tracker shares the device (run_async).
        self._defer_overflow_read = True
        # The CUDA stream of the last run_async's mapper (None on the CPU).
        self.mapper_stream = None
        self.metrics = {"ate": [], "tracking_iters": [], "frame_times": [],
                        "overflow": []}
        self._cap_bumps = 0          # overflow-triggered entry_capacity raises
        self._probe_counter = 0
        self._kf_probe_counter = 0
        self.wandb = WandbLogger(enabled=self.scfg.use_wandb, config=config)
        self._prefetcher = (_FramePrefetcher(self._load_frame_impl)
                            if self.scfg.prefetch else None)
        self.viewer = None
        self.mesh = None
        if self.scfg.mesh_devices:
            from ..parallel.mesh import make_mesh

            self.mesh = make_mesh(self.scfg.mesh_devices, self.device)

    # -- the state and the CUDA streams ----------------------------------------
    #
    # run_async's two threads launch on two CUDA streams, and nothing orders
    # them but events. Every state written to self.state carries an event
    # recorded on the writer's current stream after its last write; a
    # reader on another stream waits for it (`read_state`), and marks the
    # tensors it reads as used on its stream (`record_stream`), so that the
    # caching allocator does not hand their memory to the writer's stream
    # while the reader's kernels still read it. Keyframe frames (tracker to
    # mapper) and mapper results (mapper to tracker) travel with an event
    # the same way (`_event`, `_on_this_stream`). On the CPU all of it is
    # nothing.

    @property
    def state(self) -> MapperState | None:
        return self._state[0]

    @state.setter
    def state(self, st: MapperState | None):
        self._state = (st, self._event() if st is not None else None)

    def _event(self):
        """An event recorded on the calling thread's current stream (None
        on the CPU)."""
        if self.device.type != "cuda":
            return None
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(self.device))
        return ev

    def _on_this_stream(self, ev, tensors):
        """Order the calling thread's current stream after `ev`, and keep
        each of `tensors` from reuse until the work that stream has queued
        when the tensor is freed is done."""
        if ev is None:
            return
        cur = torch.cuda.current_stream(self.device)
        cur.wait_event(ev)
        for x in tensors:
            x.record_stream(cur)

    def read_state(self) -> MapperState:
        """self.state, safe to read on the calling thread's stream."""
        st, ev = self._state
        self._on_this_stream(ev, state_tensors(st).values())
        return st

    def _window_capacity(self) -> int:
        # Exactly window_size (add_to_window evicts down to it before the
        # mapper sees the list, and a padding slot costs a render each
        # mapping iteration), rounded up to a multiple of the mesh's ranks.
        n = self.mesh.size if self.mesh is not None else 1
        return -(-self.kcfg.window_size // n) * n

    # -- the web viewer ----------------------------------------------------------

    def start_viewer(self, port: int = 8890):
        """Start the in-process web viewer (the reference's GUI process,
        slam.py:120-121); port 0 binds a free port (`viewer.port`)."""
        from ..viewer.server import ViewerServer, make_render_fn

        self.viewer = ViewerServer(make_render_fn(self), port=port,
                                   save_dir=self.scfg.save_dir).start()
        Log(f"Viewer at http://localhost:{self.viewer.port}", tag="System")
        return self.viewer

    def _push_viewer(self, idx: int, frame: Frame):
        """The GUI pause (slam_tracker.py:335-348: the frame loop waits while
        the viewer is paused), then frame idx's packet: references to the
        state's map and the frame's images, with an event after their
        writes on this thread's stream."""
        if self.viewer is None:
            return
        from ..viewer.packets import MainToViewerPacket

        while self.viewer.paused:
            time.sleep(0.05)
        st = self.read_state().gmap
        self.viewer.push(MainToViewerPacket(
            params=st.params, active=st.active, kf_idx=st.kf_idx, obj_prob=st.obj_prob,
            intrinsics=self.intr, cur_frame_idx=idx, cur_pose=self.est_poses[idx],
            gt_pose=self.gt_poses.get(idx),
            kf_poses={i: self.est_poses[i] for i in self.kf_list},
            gt_rgb=frame.rgb, gt_depth=frame.depth, gt_segmentation=frame.segmentation,
            ready=self._event()))

    def prewarm(self):
        """Build the CUDA kernels and compile the Triton relayout before
        the frame loop (and before run_async starts its threads), so that
        no frame's time includes a compile; nothing to build on the CPU."""
        if self.device.type == "cuda":
            from ..ops import kernels

            kernels.build_all()
            kernels.rows_to_channels(torch.zeros((1, 512, 16), device=self.device))

    def _section(self, name: str):
        """A profiling section that waits for the SLAM device at its end, so
        each section's time holds the device work it dispatched."""
        return section(name, sync=True, device=self.device)

    # -- frame plumbing ------------------------------------------------------

    def _load_frame(self, idx: int) -> Frame:
        if self._prefetcher is not None:
            return self._prefetcher.get(idx)
        return self._load_frame_impl(idx)

    def _load_frame_impl(self, idx: int) -> Frame:
        d = self.dataset[idx]
        frame = make_frame(idx, d["rgb"], d.get("depth"), d["pose"], mask=d.get("mask"),
                           segmentation=d.get("segmentation"), device=self.device)
        pose = d["pose"]
        pose = pose.cpu().numpy() if torch.is_tensor(pose) else np.asarray(pose)
        self.gt_poses[idx] = (pose[:3, :3].astype(np.float32),
                              pose[:3, 3].astype(np.float32))
        return frame

    def _record_pose(self, idx: int, R, t):
        # Project R onto SO(3) (a 3x3 SVD on the host): est_poses seed the
        # next frame's tracking and the ATE, so drift off the manifold in
        # the device's retraction chain stops here.
        R = np.asarray(R, np.float64)
        U, _, Vt = np.linalg.svd(R)
        S = np.diag([1.0, 1.0, np.sign(np.linalg.det(U @ Vt))])
        self.est_poses[idx] = ((U @ S @ Vt).astype(np.float32), np.asarray(t))

    def _gc_frames(self):
        keep = set(self.kf_list) | {max(self.frames.keys(), default=0)}
        for idx in [i for i in self.frames if i not in keep]:
            del self.frames[idx]
        for idx in [i for i in self.vis_dict if i not in set(self.kf_list)]:
            del self.vis_dict[idx]

    def _checkpoint_due(self) -> bool:
        return bool(self.scfg.ckpt_every and self.scfg.save_dir
                    and len(self.kf_history) % self.scfg.ckpt_every == 0)

    def _maybe_checkpoint(self):
        """The whole state to <save_dir>/ckpt every ckpt_every keyframes."""
        if self._checkpoint_due():
            path = os.path.join(self.scfg.save_dir, "ckpt")
            with self._section("ckpt.save"):
                save_checkpoint(path, self)
            Log(f"checkpoint -> {path}", tag="System")

    # -- slab capacity -------------------------------------------------------

    def _num_tiles(self, cfg) -> int:
        return (-(-self.intr.width // cfg.tile_size)
                * -(-self.intr.height // cfg.tile_size))

    @torch.no_grad()
    def _entry_demand(self, cfg, frame: Frame) -> tuple[int, int]:
        """(padded slab rows, live entries) the current map needs at the
        frame's pose under cfg's caps; one host read."""
        st = self.read_state().gmap
        z3 = torch.zeros(3, device=self.device)
        proj = project_gaussians_ch(
            st.params["xyz"], gm.get_scales(st.params, cfg.isotropic),
            st.params["quats"], gm.get_opacity(st.params), frame.R, frame.t,
            z3, z3, self.intr, active=st.active)
        padded, entries = measure_entry_demand(
            proj.u, proj.v, proj.radius, proj.valid, proj.opacity,
            (proj.ca, proj.cb, proj.cc), img_w=self.intr.width,
            img_h=self.intr.height, tile_size=cfg.tile_size,
            tile_capacity=cfg.tile_capacity, max_dup=cfg.max_dup,
            max_dup_gen=cfg.max_dup_gen)
        padded, entries = torch.stack([padded, entries]).tolist()
        return padded, entries

    def _derive_entry_capacities(self, frame: Frame):
        """Configs that leave entry_capacity None get max(1.25x the padded
        demand at the first frame, the screen-density bound), SLAB-rounded
        and clamped to the safe auto capacity."""
        st = self.state.gmap
        for name in ("tcfg", "mcfg"):
            cfg = getattr(self, name)
            if cfg.entry_capacity is not None:
                continue
            padded, entries = self._entry_demand(cfg, frame)
            pixels = self.intr.width * self.intr.height
            rows = max(padded * 5 // 4, int(self.ENTRY_DENSITY * pixels))
            rows = -(-rows // SLAB) * SLAB
            safe = auto_entry_capacity(st.capacity, cfg.max_dup, self._num_tiles(cfg),
                                       cfg.tile_capacity)
            rows = max(min(rows, safe), SLAB)
            setattr(self, name, dataclasses.replace(cfg, entry_capacity=rows))
            Log(f"{name} entry_capacity {rows} rows (probe: {padded} padded / "
                f"{entries} entries, safe auto {safe})", tag="System")

    def _required_rows(self, cfg, frame: Frame) -> int | None:
        """The capacity the current map needs at this frame's pose (1.25x
        the padded demand, SLAB-rounded, at most the safe auto), or None
        when cfg.entry_capacity already holds it."""
        padded, _ = self._entry_demand(cfg, frame)
        rows = -(-(padded * 5 // 4) // SLAB) * SLAB
        if rows <= cfg.entry_capacity:
            return None
        safe = auto_entry_capacity(self.state.gmap.capacity, cfg.max_dup,
                                   self._num_tiles(cfg), cfg.tile_capacity)
        rows = min(rows, safe)
        return rows if rows > cfg.entry_capacity else None

    def _reprobe_tracking(self, frame: Frame):
        """Every REPROBE_EVERY tracked frames: raise the tracking capacity at
        once if the grown map's demand no longer fits."""
        self._probe_counter += 1
        if self.tcfg.entry_capacity is None or self._probe_counter % self.REPROBE_EVERY:
            return
        rows = self._required_rows(self.tcfg, frame)
        if rows is not None:
            Log(f"demand re-probe: tracking entry_capacity "
                f"{self.tcfg.entry_capacity} -> {rows}", tag="System")
            self.tcfg = dataclasses.replace(self.tcfg, entry_capacity=rows)

    def _reprobe_mapping(self, frame: Frame):
        """The mapper's counterpart, every 8 keyframes."""
        self._kf_probe_counter += 1
        if self.mcfg.entry_capacity is None or self._kf_probe_counter % 8:
            return
        rows = self._required_rows(self.mcfg, frame)
        if rows is not None:
            Log(f"demand re-probe: mapping entry_capacity "
                f"{self.mcfg.entry_capacity} -> {rows}", tag="System")
            self.mcfg = dataclasses.replace(self.mcfg, entry_capacity=rows)

    def _bump_entry_capacity(self, overflow: int):
        """Overflow backstop: raise the tracking slab capacity 1.5x (at most
        3 times) when the slab-truncation drops (overflow_parts[3], the only
        part a larger slab fixes) exceed 1% of it."""
        cap = self.tcfg.entry_capacity
        if cap is None or self._cap_bumps >= 3:
            return
        if overflow <= max(500, cap // 100):
            return
        safe = auto_entry_capacity(self.state.gmap.capacity, self.tcfg.max_dup,
                                   self._num_tiles(self.tcfg), self.tcfg.tile_capacity)
        new = min(-(-(cap * 3 // 2) // SLAB) * SLAB, safe)
        if new <= cap:
            return
        self._cap_bumps += 1
        self.tcfg = dataclasses.replace(self.tcfg, entry_capacity=new)
        Log(f"binning overflow {overflow}: tracking entry_capacity {cap} -> {new}",
            tag="System")

    def _maybe_grow(self):
        st = self.state
        free = st.gmap.capacity - int(st.gmap.num_active)
        if free < self.scfg.capacity_headroom:
            new_cap = st.gmap.capacity * 2
            Log(f"Growing map capacity -> {new_cap}", tag="System")
            gmap, adam = gm.grow(st.gmap, st.adam, new_cap)
            self.state = st._replace(gmap=gmap, adam=adam)

    # -- pipeline stages -----------------------------------------------------

    def initialize(self, frame: Frame):
        """Frame 0: seed the map from it and run the map initialisation."""
        nr_objects = getattr(self.dataset, "nr_objects", 1)
        window = window_from_list([frame], self._window_capacity())
        self.state = init_mapper_state(self.scfg.map_capacity, nr_objects, window,
                                       seed=self.scfg.seed)
        self.state, (n_added, _) = extend_event(self.state, frame, 0, self.intr,
                                                self.mcfg, init=True)
        Log(f"Map init: {int(n_added)} Gaussians", tag="Mapper")
        self._derive_entry_capacities(frame)
        self.state, vis = run_initialize_map(self.state, self.intr, self.mcfg,
                                             mesh=self.mesh)
        self.frames[0] = frame
        self.kf_list = [0]
        self._window_slots = [0]
        self.kf_history.add(0)
        self.vis_dict[0] = vis[0]
        pose = torch.cat([frame.R.reshape(-1), frame.t]).cpu().numpy()
        self._record_pose(0, pose[:9].reshape(3, 3), pose[9:])
        self._raw_poses[0] = self.est_poses[0]
        self.exposures[0] = (frame.exposure_a, frame.exposure_b)

    def track(self, idx: int, frame: Frame) -> tuple[Frame, object]:
        """Track one frame against the current map."""
        prev_R, prev_t = self.est_poses[idx - 1]
        init_R, init_t = prev_R, prev_t
        if (self.tcfg.const_velocity and (idx - 1) in self._raw_poses
                and (idx - 2) in self._raw_poses):
            init_R, init_t = const_velocity_init(
                self._raw_poses[idx - 1], self._raw_poses[idx - 2],
                base=(prev_R, prev_t))
        f32 = torch.float32
        frame = frame._replace(R=torch.as_tensor(init_R, dtype=f32, device=self.device),
                               t=torch.as_tensor(init_t, dtype=f32, device=self.device))
        gmap = self.read_state().gmap
        with self._section("track.dispatch"):
            res = track_frame(gmap.params, gmap.active, frame, self.intr, self.tcfg)
        frame = frame._replace(R=res.R, t=res.t, exposure_a=res.exposure_a,
                               exposure_b=res.exposure_b)
        # One host read for all of the frame's bookkeeping.
        with self._section("track.readback"):
            hs = unpack_host_stats(res.host_stats)
        self._record_pose(idx, hs["R"], hs["t"])
        self._raw_poses[idx] = self.est_poses[idx]
        self._raw_poses.pop(idx - 2, None)
        self.exposures[idx] = (res.exposure_a, res.exposure_b)
        self.median_depth = hs["median_depth"]
        self.metrics["tracking_iters"].append(hs["n_iters"])
        # Binning drops must show: the parts name the knob to raise; only
        # slab truncation (parts[3]) is fixed by the capacity bump.
        overflow, parts = hs["overflow"], hs["overflow_parts"]
        self.metrics["overflow"].append(overflow)
        if overflow > 100:
            advice = []
            if parts[0] or parts[1]:
                advice.append(f"max_dup_gen/max_dup (+{parts[0]}/+{parts[1]} "
                              f"wide-gaussian dups)")
            if parts[2]:
                advice.append(f"tile_capacity (+{parts[2]} dense-tile)")
            if parts[3]:
                advice.append(f"entry_capacity (+{parts[3]} slab)")
            Log(f"tracking frame {idx}: binning dropped {overflow} entries "
                f"— raise {'; '.join(advice)}", tag="Tracker")
        self._bump_entry_capacity(parts[3])
        self._reprobe_tracking(frame)
        return frame, res

    def _mapper_keyframe(self, idx: int, frame: Frame, kf_list: list, fetch_frame=None):
        """The mapper's keyframe work: extend the map from the keyframe,
        optimise the window, prune. `fetch_frame(i) -> Frame` is read only
        when the window slots are unknown. -> (window_host_pack, vis)."""
        self._maybe_grow()  # before seeding, so no candidates are dropped
        self._reprobe_mapping(frame)
        with self._section("kf.extend"):
            self.state, (_, n_dropped) = extend_event(self.state, frame, idx, self.intr,
                                                      self.mcfg, init=False)
            # Read at the end of the run (metrics["seed_drops"]), not here:
            # a read now would wait for the extend render.
            self.metrics.setdefault("seed_drops", []).append((idx, n_dropped))

        # The window, newest first as kf_list, by permutation of the
        # previous window on the device plus the new frame.
        with self._section("kf.window_build"):
            cap = self._window_capacity()
            slots = self._window_slots
            pos = {k: s for s, k in enumerate(slots)} if slots is not None else None
            if pos is not None and all(k == idx or k in pos for k in kf_list) \
                    and len(kf_list) <= cap:
                perm = torch.zeros(cap, dtype=torch.int64)
                for s, k in enumerate(kf_list):
                    perm[s] = pos.get(k, 0)
                valid = torch.zeros(cap, dtype=torch.bool)
                valid[: len(kf_list)] = True
                window = window_update(self.state.window, frame, perm, valid)
            else:
                window = window_from_list(
                    [frame if i == idx else fetch_frame(i) for i in kf_list], cap)
            self.state = self.state._replace(
                window=window, pose_adam=init_pose_adam(cap, self.device))
            self._window_slots = list(kf_list)

        with self._section("kf.optimize"):
            self.state, vis = run_optimize_map(self.state, self.intr, self.mcfg,
                                               self.mcfg.iters_per_kf,
                                               defer_overflow_read=self._defer_overflow_read,
                                               mesh=self.mesh)
        if len(kf_list) == self.kcfg.window_size:
            # The first full window may prune from any keyframe; later ones
            # only Gaussians of the three newest keyframes.
            if not self.first_time_pruned:
                floor = -(2 ** 31)
                self.first_time_pruned = True
            else:
                floor = sorted(kf_list, reverse=True)[2]
            with self._section("kf.prune"):
                self.state, _ = covisibility_prune(self.state, vis, floor, self.mcfg)
                vis = visibility_pass(self.state, self.intr, self.mcfg)
        return window_host_pack(self.state), vis

    def _apply_mapper_result(self, kf_list: list, host_pack, vis):
        """Write the optimised window poses, exposures and visibility back
        into the host bookkeeping; one host read of host_pack."""
        with self._section("kf.apply_result"):
            w = unpack_window_host(host_pack, self._window_capacity())
            for slot, i in enumerate(kf_list):
                self._record_pose(i, w["R"][slot], w["t"][slot])
                self.exposures[i] = (float(w["exposure_a"][slot]),
                                     float(w["exposure_b"][slot]))
                self.vis_dict[i] = vis[slot]

    def _fetch_frames_at_pose(self, idxs) -> list[Frame]:
        """Frames idxs with their current pose and exposure estimates
        applied, on the SLAM device; the estimates of all of them go to the
        device in one copy."""
        frames = [self.frames[i] if i in self.frames else self._load_frame(i)
                  for i in idxs]
        host = np.zeros((len(idxs), 14), np.float32)
        for row, i in zip(host, idxs):
            R, t = self.est_poses[i]
            row[:9], row[9:12] = np.asarray(R).ravel(), t
            row[12:] = [float(e) for e in self.exposures.get(i, (0.0, 0.0))]
        est = torch.as_tensor(host, device=self.device)
        return [f._replace(R=e[:9].reshape(3, 3), t=e[9:12], exposure_a=e[12],
                           exposure_b=e[13]) for f, e in zip(frames, est)]

    def _fetch_frame_at_pose(self, idx: int) -> Frame:
        """Frame idx with the current pose and exposure estimate applied."""
        return self._fetch_frames_at_pose([idx])[0]

    def handle_keyframe(self, idx: int, frame: Frame, kf_list=None):
        """Mapper work and its result's application, in one thread."""
        if kf_list is not None:
            self.kf_list = list(kf_list)
        host_pack, vis = self._mapper_keyframe(idx, frame, list(self.kf_list),
                                               fetch_frame=self._fetch_frame_at_pose)
        self._apply_mapper_result(list(self.kf_list), host_pack, vis)

    def process_frame(self, idx: int) -> dict:
        """One tracking and (on a keyframe) mapping cycle for frame idx."""
        t0 = time.time()
        with self._section("frame.load"):
            frame = self._load_frame(idx)
        if idx == 0:
            with self._section("init"):
                self.initialize(frame)
            self.metrics["frame_times"].append(time.time() - t0)
            return {"keyframe": True}

        frame, res = self.track(idx, frame)
        self.frames[idx] = frame
        create_kf = self._is_keyframe(idx, frame, res)
        self._push_viewer(idx, frame)
        if create_kf:
            self._add_keyframe(idx, res)
            self.handle_keyframe(idx, frame)
            self._maybe_checkpoint()
        self._gc_frames()
        self.metrics["frame_times"].append(time.time() - t0)
        return {"keyframe": create_kf}

    def _is_keyframe(self, idx: int, frame: Frame, res) -> bool:
        """The keyframe decision for tracked frame idx."""
        last_kf = self.kf_list[0]
        create_kf = (idx - last_kf) >= self.kcfg.kf_interval
        if create_kf and self.kcfg.check_viewpoints_overlap:
            pose = torch.cat([frame.R.reshape(-1), frame.t]).cpu().numpy()
            create_kf = kf.should_add_as_keyframe(
                (pose[:9].reshape(3, 3), pose[9:]), self.est_poses[last_kf], res.visibility,
                self.vis_dict[last_kf], self.median_depth, self.kcfg)
        return create_kf

    def _add_keyframe(self, idx: int, res):
        """Frame idx into the keyframe history and the window's list."""
        self.kf_history.add(idx)
        self.vis_dict[idx] = res.visibility
        with self._section("kf.window_select"):
            self.kf_list, _ = kf.add_to_window(
                idx, res.visibility, self.kf_list, self.vis_dict, self.est_poses,
                self.kcfg, self.is_window_full)
        if len(self.kf_list) == self.kcfg.window_size:
            self.is_window_full = True

    # -- refinement ----------------------------------------------------------

    def refine(self, iters: int | None = None):
        """Colour refinement of the map after the frame loop: `iters`
        iterations (default mcfg.refine_iters) on keyframes drawn at random
        (random.Random(scfg.seed) over sorted(kf_history), the JAX
        package's draws), each at its refined pose and tracked exposure.
        The keyframes go to the device once, before the loop. Colours-only
        (the default): one draw per span of up to 8 iterations, binned once
        (`refine_span`); all-params: chunks of 8 draws (`refine_chunk`),
        then single steps. The overflow is read every 200 iterations and at
        the end, and its maximum kept in metrics["refine_overflow_max"]."""
        iters = self.mcfg.refine_iters if iters is None else iters
        rng = random.Random(self.scfg.seed)
        kf_idxs = sorted(self.kf_history)
        B = 8
        done = overflow_max = 0
        with self._section("refine"):
            staged = dict(zip(kf_idxs, self._fetch_frames_at_pose(kf_idxs)))

            def draw() -> Frame:
                return staged[kf_idxs[rng.randrange(len(kf_idxs))]]

            while done < iters:
                if self.mcfg.refine_colors_only:
                    n = min(B, iters - done)
                    self.state, ov = refine_span(self.state, draw(), self.intr,
                                                 self.mcfg, n)
                elif iters - done >= B:
                    batch = [draw() for _ in range(B)]
                    n = B
                    self.state, ov = refine_chunk(
                        self.state, Frame(*(torch.stack(x) for x in zip(*batch))),
                        self.intr, self.mcfg)
                else:
                    n = 1
                    self.state, ov = refine_step(self.state, draw(), self.intr, self.mcfg)
                done += n
                if done % 200 < B or done >= iters:
                    overflow_max = max(overflow_max, int(ov))
        if overflow_max and not self.mcfg.refine_colors_only:
            Log(f"refine renders dropped up to {overflow_max} entries (raise "
                f"MapperConfig.refine_tile_capacity / refine_max_dup): refined "
                f"geometry against truncated images", tag="Mapper")
        elif overflow_max:
            Log(f"refine (colours only) peak binning drop {overflow_max} "
                f"entries/render", tag="Mapper")
        self.metrics["refine_overflow_max"] = overflow_max

    # -- evaluation and export -----------------------------------------------

    def eval_ate(self, label="final", align=False, align_scale=False) -> float:
        rmse = eval_traj_ate(self.est_poses, self.gt_poses, save_dir=self.scfg.save_dir,
                             label=label, align=align, align_scale=align_scale)
        self.metrics["ate"].append(rmse)
        self.wandb.log({"frame_idx": max(self.est_poses, default=0), "ate": rmse})
        return rmse

    @torch.no_grad()
    def render_at(self, idx: int) -> torch.Tensor:
        """Render the map at the estimated pose of frame idx -> (H, W, 3)
        rgb clipped to [0, 1], on the SLAM device.

        Eval renders use generous binning caps (max_dup 32, the safe auto
        entry capacity), not the loop's: the metric must measure the map,
        not the binning budget (the JAX package measured a final map's
        demand past the loop's capacity turning whole tile rows black)."""
        R, t = self.est_poses[idx]
        p = self.state.gmap.params
        f32, dev = torch.float32, self.device
        out = render(p["xyz"], gm.get_scales(p, self.mcfg.isotropic), p["quats"],
                     gm.get_opacity(p), p["rgb"], torch.as_tensor(R, dtype=f32, device=dev),
                     torch.as_tensor(t, dtype=f32, device=dev), self.intr,
                     active=self.state.gmap.active,
                     tile_capacity=max(self.mcfg.tile_capacity, 4096),
                     max_dup=max(self.mcfg.max_dup, 32), max_dup_gen=None,
                     entry_capacity=None, backend=self.mcfg.backend,
                     with_n_touched=False)
        overflow = int(out.overflow)
        if overflow > 1000:
            Log(f"eval render frame {idx}: {overflow} entries dropped even at eval "
                f"capacities", tag="Eval")
        return torch.clamp(out.rgb, 0.0, 1.0)

    def eval_rendering(self, every: int = 5, label="final") -> dict:
        """PSNR / SSIM over every `every`-th non-keyframe frame (the
        reference's held-out protocol: keyframes were trained on)."""
        idxs = [i for i in sorted(self.est_poses)
                if i % every == 0 and i not in self.kf_history]
        if not idxs:
            # kf_interval == every makes every every-th frame a keyframe:
            # stride over the non-keyframes instead.
            non_kf = [i for i in sorted(self.est_poses) if i not in self.kf_history]
            idxs = non_kf[::every]
        train_view_inflated = False
        if not idxs:
            Log("every frame is a keyframe; eval includes them", tag="Eval")
            idxs = [i for i in sorted(self.est_poses) if i % every == 0]
            # Flagged in the artifact: PSNR over train views is not the
            # held-out number.
            train_view_inflated = True
        res = eval_rendering(
            self.render_at, lambda i: (self.dataset[i]["rgb"], self.dataset[i].get("depth")),
            idxs, save_dir=self.scfg.save_dir, label=label,
            extra={"train_view_inflated": True} if train_view_inflated else None)
        self.wandb.log({k: v for k, v in res.items() if isinstance(v, (int, float))})
        return res

    def save_map(self, path: str):
        """The active Gaussians as a PLY. Isotropic maps write scale 0 on
        all three axes (get_scales reads channel 0 only; channels 1-2 hold
        untrained values a viewer would render)."""
        st = self.state.gmap
        active = st.active.cpu().numpy()
        host = {k: v.detach().cpu().numpy()[active] for k, v in st.params.items()}
        log_scales = host["log_scales"]
        if self.mcfg.isotropic:
            log_scales = np.repeat(log_scales[:, :1], 3, axis=1)
        save_ply(path, host["xyz"], host["rgb"], host["opacity_logit"], log_scales,
                 host["quats"])

    def _record_fps(self, n_frames: int, wall_s: float):
        """Throughput of the frame loop (tracking, mapping, loading; no
        eval)."""
        fps = n_frames / max(wall_s, 1e-9)
        self.metrics["fps"] = fps
        self.metrics["wall_s"] = wall_s
        drops = [(i, int(d)) for i, d in self.metrics.get("seed_drops", [])]
        self.metrics["seed_drops"] = drops
        for i, d in drops:
            if d:
                Log(f"Capacity drop at kf {i}: {d} seeds", tag="Mapper")
        Log(f"{n_frames} frames in {wall_s:.1f}s = {fps:.2f} fps", tag="System")
        self.wandb.log({"fps": fps})

    def run(self, n_frames: int | None = None, start_frame: int = 0) -> float:
        """SLAM over the first n_frames frames (default: all), from
        start_frame (> 0 continues a restored run), then the final ATE and,
        with a save_dir, the map's PLY. -> final ATE RMSE."""
        n = len(self.dataset) if n_frames is None else n_frames
        wall0 = time.time()
        for idx in range(start_frame, n):
            self.process_frame(idx)
            if self.scfg.eval_every and idx > 0 and idx % self.scfg.eval_every == 0:
                rmse = self.eval_ate(label=f"{idx}")
                it = self.metrics["tracking_iters"][-self.scfg.eval_every:]
                Log(f"frame {idx}: ATE RMSE {rmse:.4f} (tracking iters last "
                    f"{len(it)}: mean {sum(it) / max(len(it), 1):.0f} max {max(it)})",
                    tag="Eval")
        return self._finish(n - start_frame, wall0)

    def _finish(self, n_frames: int, wall0: float, mode: str = "") -> float:
        """The end of a frame loop: fps, the final ATE and the PLY."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._record_fps(n_frames, time.time() - wall0)
        rmse = self.eval_ate(label="final")
        Log(f"final ATE RMSE {rmse:.4f}{mode}", tag="Eval")
        if self.scfg.save_dir:
            self.save_map(f"{self.scfg.save_dir}/point_cloud/final/point_cloud.ply")
        return rmse

    def run_async(self, n_frames: int | None = None, queue_depth: int = 2,
                  mapper_timeout: float = 600.0, start_frame: int = 0) -> float:
        """The tracker and the mapper concurrently (the reference's
        two-process topology as two host threads). -> final ATE RMSE.

        Ownership: the calling (tracker) thread owns the host bookkeeping
        (frames, poses, exposures, visibility, keyframe list, metrics); the
        mapper thread owns the map state, swapping whole new states into
        self.state (the map's functions build new tensors and never write
        the tensors a reader holds), and the mapper-side flags. A keyframe
        goes to the mapper on a bounded queue (backpressure: at most
        queue_depth events wait), with its frame and keyframe list by value;
        its result (the window's optimised poses and exposures, the
        visibility) comes back on a result queue, and the tracker applies
        it between frames. The first SystemConfig.async_bootstrap_kfs
        keyframe events, and every event after which a checkpoint is due,
        are waited for at once (a checkpoint is then of a state with no
        event in flight). With a mesh every event is waited for at once:
        the ranks' trackers must read the same states, and a state that a
        mapper thread swaps in mid-frame is read at no fixed frame; the
        mapper's collectives (its thread's and its backward's) then run
        in one order on every rank.

        Streams: on a card the mapper thread runs on a CUDA stream of its
        own for its whole life, the tracker (and the frame prefetcher) on
        the default stream, as in `run`; see the state section above for
        the events that order them. The mapper reads the map's overflow
        once per span (not once per event), so that it never queues a
        whole event's work ahead of the tracker's.

        No fallback: a mapper exception ends the run with
        RuntimeError("mapper thread failed") chained from it. Whatever ends
        the loop, the mapper thread is stopped and joined and the overflow
        read policy restored."""
        q: queue.Queue = queue.Queue(maxsize=queue_depth)
        results: queue.Queue = queue.Queue()
        errors: list[BaseException] = []
        stop = object()
        stream = torch.cuda.Stream(self.device) if self.device.type == "cuda" else None
        self.mapper_stream = stream
        pending: dict[int, int] = {}    # keyframe -> frames tracked at its message
        tracked = in_flight = 0
        staleness = self.metrics.setdefault("async_staleness", [])

        def mapper_loop():
            with torch.cuda.stream(stream):
                while True:
                    msg = q.get()
                    if msg is stop:
                        return
                    try:
                        idx, frame, kf_list, ready = msg
                        self._on_this_stream(ready, frame)
                        self.read_state()
                        host_pack, vis = self._mapper_keyframe(
                            idx, frame, kf_list, fetch_frame=self._fetch_frame_at_pose)
                        results.put((idx, kf_list, host_pack, vis, self._event()))
                    except BaseException as e:   # handed to the tracker thread
                        errors.append(e)
                        return

        def check():
            if errors:
                raise RuntimeError("mapper thread failed") from errors[0]
            if not mapper.is_alive():
                raise RuntimeError("mapper thread failed: it is not running")

        def drain(block: bool):
            """Apply the results that are back; with block, wait for all."""
            deadline = time.monotonic() + mapper_timeout
            while pending:
                try:
                    idx, kf_list, host_pack, vis, ready = results.get(timeout=0.05) \
                        if block else results.get_nowait()
                except queue.Empty:
                    if not block:
                        return
                    check()
                    if time.monotonic() > deadline:
                        raise TimeoutError(f"no mapper result in {mapper_timeout} s")
                    continue
                self._on_this_stream(ready, (host_pack, vis))
                self._apply_mapper_result(kf_list, host_pack, vis)
                staleness.append(tracked - pending.pop(idx))

        def send(msg):
            deadline = time.monotonic() + mapper_timeout
            while True:
                check()
                try:
                    q.put(msg, timeout=0.05)
                    return
                except queue.Full:
                    if time.monotonic() > deadline:
                        raise

        mapper = threading.Thread(target=mapper_loop, name="mapper", daemon=True)
        self._defer_overflow_read = False
        mapper.start()
        finished = False
        try:
            bootstrap_left = self.scfg.async_bootstrap_kfs
            n = len(self.dataset) if n_frames is None else n_frames
            wall0 = time.time()
            for idx in range(start_frame, n):
                t0 = time.time()
                check()
                with self._section("frame.load"):
                    frame = self._load_frame(idx)
                if idx == 0:
                    with self._section("init"):
                        self.initialize(frame)
                    self.metrics["frame_times"].append(time.time() - t0)
                    continue
                drain(block=False)
                in_flight += bool(pending)
                frame, res = self.track(idx, frame)
                tracked += 1
                self.frames[idx] = frame
                create_kf = self._is_keyframe(idx, frame, res)
                self._push_viewer(idx, frame)
                if create_kf:
                    self._add_keyframe(idx, res)
                    pending[idx] = tracked
                    send((idx, frame, list(self.kf_list), self._event()))
                    if bootstrap_left > 0 or self._checkpoint_due() or self.mesh is not None:
                        bootstrap_left = max(bootstrap_left - 1, 0)
                        drain(block=True)
                    self._maybe_checkpoint()
                self._gc_frames()
                self.metrics["frame_times"].append(time.time() - t0)
            finished = True
        finally:
            if not finished:             # drop the queued events, then stop
                while True:
                    try:
                        q.get_nowait()
                    except queue.Empty:
                        break
            deadline = time.monotonic() + mapper_timeout
            while mapper.is_alive() and time.monotonic() < deadline:
                try:
                    q.put(stop, timeout=0.05)
                    break
                except queue.Full:
                    pass
            mapper.join(timeout=max(deadline - time.monotonic(), 0.0))
            self._defer_overflow_read = True
            if stream is not None:
                torch.cuda.current_stream(self.device).wait_stream(stream)
        if mapper.is_alive():
            raise RuntimeError(f"the mapper thread did not stop in {mapper_timeout} s")
        if errors:
            raise RuntimeError("mapper thread failed") from errors[0]
        drain(block=False)
        if pending:
            raise RuntimeError(f"keyframe events {sorted(pending)} returned no result")
        self.read_state()
        self.metrics["frames_tracked_in_flight"] = in_flight
        return self._finish(n - start_frame, wall0, " (async)")
