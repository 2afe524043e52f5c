"""monogs_torch's SLAM with the mapper's window sharded over 2 ranks against
one rank, on the CPU (the port of tests/test_parallel.py::
test_sharded_slam_e2e): the ranks are processes of
tests/test_torch_parallel.py joined by gloo, each running the whole frame loop
on the same stream, through `run` and through `run_async`. The sharded run
must track and map like the unsharded one (ATE within 1e-3, active counts
within 50, tests/test_parallel.py:236-242), and every rank must end with
rank 0's map bit for bit: the ranks track on their own, so their maps stay
equal only if every rank computes the same bits. The command line's
--dist-* and --viewer at 2 ranks, through parallel/launch.py, close the
file.
"""

import os

import numpy as np
import pytest
import torch

import test_torch_parallel as tp

torch.set_num_threads(2)   # the test workers share the CPUs (tests/test_torch_system.py)

# tests/test_parallel.py::test_sharded_slam_e2e's scene and budgets.
CFG = {
    "Dataset": {
        "type": "synthetic",
        "Calibration": {"width": 64, "height": 48, "fx": 50.0, "fy": 50.0,
                        "cx": 32.0, "cy": 24.0, "depth_scale": 1.0},
        "Objects": {"static": [0], "dynamic": [], "masked": []},
        "synthetic": {"n_frames": 5, "n_gaussians": 500, "seed": 7, "motion_scale": 0.008},
    },
}


def build_slam(mesh_devices: int):
    from monogs_torch.data.synthetic import SyntheticDataset
    from monogs_torch.slam.keyframes import KeyframeConfig
    from monogs_torch.slam.mapper import MapperConfig
    from monogs_torch.slam.system import SLAM
    from monogs_torch.slam.tracker import TrackerConfig
    from monogs_torch.utils.config import SystemConfig

    return SLAM(SyntheticDataset(CFG, device="cpu"),
                tracker_config=TrackerConfig(tile_size=16, max_iters=10, tile_capacity=128,
                                             max_dup=16, backend="ref",
                                             opacity_threshold=0.5),
                mapper_config=MapperConfig(tile_size=16, init_itr_num=20,
                                           init_gaussian_update=10, init_gaussian_reset=100,
                                           iters_per_kf=6, gaussian_update_every=1000,
                                           prune_coviz=1, tile_capacity=128, max_dup=16,
                                           backend="ref"),
                keyframe_config=KeyframeConfig(window_size=6),
                system_config=SystemConfig(map_capacity=4096, capacity_headroom=256,
                                           eval_every=0, mesh_devices=mesh_devices),
                device="cpu")


@pytest.mark.parametrize("mode", ["run", "run_async"])
def test_sharded_slam_e2e(tmp_path, monkeypatch, mode):
    """`run` and `run_async` (which, with a mesh, waits for each keyframe
    event) on 2 ranks against `run` on one."""
    monkeypatch.setenv("MONOGS_SYNTH_CACHE", "0")
    procs = tp._spawn("slam", 2, tmp_path, int(mode == "run_async"))
    try:
        single = build_slam(0)
        rmse_single = single.run()
    finally:
        tp._join(procs)
    ranks = [torch.load(os.path.join(tmp_path, f"slam2_{r}.pt"), weights_only=False)
             for r in range(2)]
    assert np.isfinite(ranks[0]["ate"])
    np.testing.assert_allclose(ranks[0]["ate"], rmse_single, atol=1e-3)
    assert abs(int(ranks[0]["active"].sum()) - int(single.state.gmap.num_active)) < 50
    r0, r1 = ranks
    assert torch.equal(r0["active"], r1["active"])
    for k in r0["params"]:
        assert torch.equal(r0["params"][k], r1["params"][k]), k
    assert r0["ate"] == r1["ate"]
    for i, (R, t) in r0["poses"].items():
        assert np.array_equal(R, r1["poses"][i][0]) and np.array_equal(t, r1["poses"][i][1])


def test_cli_two_ranks_with_viewer(tmp_path, capsys, monkeypatch):
    """`python -m monogs_torch` as 2 ranks over gloo (--dist-*, started by
    parallel/launch.py) on configs/synthetic/cpu_smoke.yaml with
    mesh_devices 2 and --viewer on both command lines: rank 0 serves the
    viewer (a second server on the port would fail rank 1), evaluates and
    writes metrics.json; rank 1 writes its run under <save_dir>/rank1/ and
    no metrics; both end with byte-equal PLYs."""
    import json
    import threading
    import time
    import urllib.request

    from monogs_torch.parallel import launch

    monkeypatch.setenv("OMP_NUM_THREADS", "1")      # each rank's torch threads
    monkeypatch.setenv("MONOGS_SYNTH_CACHE", "0")
    viewer, served, done = launch.free_port(), [], threading.Event()

    def poll():
        while not done.is_set() and not served:
            try:
                with urllib.request.urlopen(f"http://127.0.0.1:{viewer}/state", timeout=5) as r:
                    served.append(r.status)
            except OSError:
                time.sleep(0.2)

    poller = threading.Thread(target=poll, daemon=True)
    poller.start()
    try:
        rc = launch.main(["--ranks", "2", "--config", "configs/synthetic/cpu_smoke.yaml",
                          "--out", str(tmp_path), "--timeout", str(tp.RANK_TIMEOUT),
                          "--device", "cpu", "--eval", "--viewer", str(viewer)])
    finally:
        done.set()
        poller.join(timeout=10)
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0 and res["maps_equal"] and not res["failed"], res
    assert served == [200]
    assert res["n_frames"] == 8 and np.isfinite(res["psnr"]) and res["map_active"] > 0
    runs = sorted(d for d, _, fs in os.walk(tmp_path) if "config.yml" in fs)
    rank1 = [d for d in runs if f"{os.sep}rank1{os.sep}" in d]
    rank0 = [d for d in runs if d not in rank1]
    assert len(rank0) == len(rank1) == 1, runs
    assert os.path.exists(os.path.join(rank0[0], "metrics.json"))
    assert not os.path.exists(os.path.join(rank1[0], "metrics.json"))
