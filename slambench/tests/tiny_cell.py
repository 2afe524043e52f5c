"""A cell's run at a size the CPU holds: the harness's whole run (set-up,
window, captures, the reference's comparison) with the program on the CPU,
where it runs its kernels' plain twins. The chip check is skipped; nothing
else is. Its caps hold every entry: a Gaussian may cover all 24 tiles, and
a tile may list every Gaussian of the map. The map is initialised with 30 iterations, not 1,050, so the
trajectory is not the cell's: the ATE limit is lifted here, and the other
numbers keep the cell's own limits."""

import torch

from slambench import core

TINY = {
    "Dataset": {"Calibration": {"width": 96, "height": 64, "fx": 80.0, "fy": 80.0,
                                "cx": 48.0, "cy": 32.0},
                "synthetic": {"n_gaussians": 3000}},
    "Training": {"init_itr_num": 30, "init_gaussian_update": 10, "init_gaussian_reset": 100,
                 "tracking_itr_num": 10, "mapping_itr_num": 8, "window_size": 4,
                 "prune_coviz": 1},
    "Raster": {"tile_size": 16, "max_dup": 24, "max_dup_gen": 24, "tile_capacity": 4096,
               "tracking_tile_capacity": 4096, "entry_capacity": 98304,
               "tracking_entry_capacity": 98304},
    "System": {"map_capacity": 16384, "capacity_headroom": 1024},
    "Benchmark": {"ate": {"limit_m": 1.0}},
}


def run(cell: str, seed: int = 4242, frames: int = 8, controls=()) -> dict:
    """One run over frames 1..frames-1 (one keyframe event at frame 5)."""
    torch.set_num_threads(2)
    files = core.cell_files(cell)
    core.prepare_environment(files["config"])
    files["workload"] = dict(files["workload"], frames_rendered=frames)
    return core.run_cell(cell, seed, 600.0, False, device="cpu", config_overrides=TINY,
                         files=files, controls=controls)
