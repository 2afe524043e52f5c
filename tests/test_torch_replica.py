"""MonoGS's Replica RGB-D deployment (slambench/configs/replica-rgbd.yaml)
on the CPU, at a size the CPU holds: the keyframe extend renders at the
configured tile, and a SLAM whose slab (entry) capacities are left to the
system's derivation drops no tile entry while its map grows, because the
probe after each event that grows the map raises them first.

The run is the benchmark harness's own (`slambench.core.run_cell`, the
program on the CPU running its kernels' plain twins) on the seeded room
through a camera of Replica's aspect and field of view at a tenth of its
size (120x68, fx = fy = 60), tile 32 as the cell's, max_dup every tile.
The map is seeded sparsely (one pixel in 1,024) and the keyframe densely
(one in 16), so the keyframe's extend fills tiles the seeded map left
empty and its slab demand outgrows what the seeding needed. One run
serves two tests (a module fixture). No JAX here."""

import dataclasses
import sys
import threading

import pytest
import torch

from monogs_torch.ops import render as render_mod
from monogs_torch.ops.graphics import Intrinsics
from monogs_torch.slam import mapper as tm
from monogs_torch.slam.camera import make_frame, window_from_list
from monogs_torch.slam.system import SLAM
from monogs_torch.utils import profiling
from slambench import core

torch.set_num_threads(2)   # the test workers share the CPUs (tests/test_torch_system.py)

CELL = "replica-rgbd.stream"
CAMERA = {"width": 120, "height": 68, "fx": 60.0, "fy": 60.0, "cx": 59.5, "cy": 33.5}
TILES = 4 * 3              # the 120x68 image in tiles of 32
SMALL = {
    "Dataset": {"Calibration": CAMERA, "synthetic": {"n_gaussians": 3000},
                "pcd_downsample_init": 1024, "pcd_downsample": 16},
    # Densify after init iterations 1 and 3; the keyframe event at frame 5.
    "Training": {"init_itr_num": 3, "init_gaussian_update": 2, "init_gaussian_reset": 100,
                 "tracking_itr_num": 3, "mapping_itr_num": 3, "window_size": 4,
                 "prune_coviz": 1},
    # No entry_capacity and no tracking_entry_capacity, as in the cell.
    "Raster": {"max_dup": TILES, "max_dup_gen": TILES},
    "System": {"map_capacity": 16384, "capacity_headroom": 1024},
    # 5 init iterations, not 1,050: the trajectory is not the cell's.
    "Benchmark": {"ate": {"limit_m": 1.0}},
}


def test_extend_event_bins_at_the_configured_tile(monkeypatch):
    """The keyframe extend's render bins at cfg.tile_size (32 here), not at
    render's default of 16: its tile_bin sees the image's 4 x 3 tiles of
    32, and max_dup = max_dup_gen = 12 then holds every coverage."""
    intr = Intrinsics(**CAMERA)
    g = torch.Generator().manual_seed(0)
    depth = 1.5 + 0.5 * torch.rand((intr.height, intr.width), generator=g)
    rgb = torch.rand((intr.height, intr.width, 3), generator=g)
    eye = torch.eye(4).numpy()
    frame = make_frame(0, rgb, depth, eye, device="cpu")
    cfg = tm.MapperConfig(tile_size=32, tile_capacity=1024, max_dup=TILES, max_dup_gen=TILES,
                          pcd_downsample_init=16, pcd_downsample=16)
    state = tm.init_mapper_state(4096, 1, window_from_list([frame], 2), seed=0)
    state, _ = tm.extend_event(state, frame, 0, intr, cfg, init=True)
    tiles = []
    orig = render_mod.tile_bin

    def spy(*args, img_w, img_h, tile_size, **kw):
        tiles.append((-(-img_w // tile_size)) * (-(-img_h // tile_size)))
        return orig(*args, img_w=img_w, img_h=img_h, tile_size=tile_size, **kw)

    monkeypatch.setattr(render_mod, "tile_bin", spy)
    tm.extend_event(state, frame, 1, intr, cfg, init=False)
    assert tiles == [TILES]


@pytest.fixture(scope="module")
def small_run():
    """The harness's run of the cell, frames 1-5, with the profiling totals
    of set-up and window both kept. -> (result, profiling summary)."""
    profiling.reset()
    mp = pytest.MonkeyPatch()
    mp.setattr(profiling, "reset", lambda: None)   # run_cell's reset after set-up
    try:
        files = core.cell_files(CELL)
        core.prepare_environment(files["config"])
        files["workload"] = dict(files["workload"], frames_rendered=6)
        r = core.run_cell(CELL, 2718282601, 600.0, False, device="cpu",
                          config_overrides=SMALL, files=files)
        summ = profiling.summary()
    finally:
        mp.undo()
        profiling.reset()
    return r, summ


def test_growing_map_drops_nothing_and_raises_a_capacity_at_an_event(small_run):
    """No binning of set-up or frames drops an entry, and a slab capacity
    rose at the keyframe event's probe (after its extend), past what the
    probes of the init (after the seeding and each densify) had set."""
    r, summ = small_run
    assert r["checks"]["dropped_entries"]["value"] == 0
    raises = summ["counters"]["capacity_raise"]["paths"]
    assert any(p.startswith("frame/init/") for p in raises), raises
    assert any("/kf." in p for p in raises), raises
    assert summ["probe"]["n"] >= 5      # the seeding, 2 densifies, before and after the extend
    assert any(p.endswith("/kf.extend/probe") for p in summ["probe"]["paths"])
    counters = summ["counters"]
    assert counters["slab_rows"]["value"] > counters["slab_live"]["value"] > 0


def test_tiny_replica_cell_is_correct(small_run):
    """The harness's whole run at that size: the system against the plain
    reference on the seeded room, under the cell's own limits."""
    r, _ = small_run
    assert r["correct"], r["checks"]
    assert r["_info"]["map_captures"] >= 1 and r["_info"]["track_captures"] >= 3


def test_capacity_raises_from_two_threads_keep_the_largest():
    """run_async's mapper probes and tracker backstops both raise the
    tracking capacity: the raises only ever go up, whatever the order."""
    @dataclasses.dataclass(frozen=True)
    class Cfg:
        entry_capacity: int

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    slam = SLAM.__new__(SLAM)
    slam._cap_lock, slam.tcfg = threading.Lock(), Cfg(512)
    profiling.reset()
    try:
        def raise_all(rows):
            for r in rows:
                slam._raise_capacity("tcfg", r, "test")

        threads = [threading.Thread(target=raise_all, args=(range(512 + k, 4000, 4),))
                   for k in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    finally:
        sys.setswitchinterval(interval)
        counts = profiling.summary()["counters"]["capacity_raise"]["n"]
        profiling.reset()
    assert slam.tcfg.entry_capacity == 3999
    assert counts <= 4000 - 512
