"""monogs_torch's web viewer on the CPU (the port of tests/test_viewer.py's
viewer test and tests/test_utils.py's LatestSlot test): the HTTP surface
over a live SLAM, the port's render_fn held against monogs_tpu's on one
state in every shader (the followed camera, an orbit, a keyframe view; at
the default width and downscaled), and the pause blocking the frame loop.

Every server binds a free port (port 0): another test worker may hold a
fixed one.
"""

import dataclasses
import json
import os
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from monogs_torch.data.synthetic import SyntheticDataset
from monogs_torch.slam.keyframes import KeyframeConfig
from monogs_torch.slam.mapper import MapperConfig
from monogs_torch.slam.system import SLAM
from monogs_torch.slam.tracker import TrackerConfig
from monogs_torch.utils.config import SystemConfig
from monogs_torch.utils.images import decode_png
from monogs_torch.viewer.packets import LatestSlot
from monogs_torch.viewer.server import make_render_fn

torch.set_num_threads(2)   # the test workers share the CPUs (tests/test_torch_system.py)

# tests/test_viewer.py's scene and budgets.
CFG = {
    "Dataset": {
        "type": "synthetic",
        "Calibration": {"width": 64, "height": 48, "fx": 50.0, "fy": 50.0,
                        "cx": 32.0, "cy": 24.0, "depth_scale": 1.0},
        "Objects": {"static": [0], "dynamic": [], "masked": []},
        "synthetic": {"n_frames": 3, "n_gaussians": 300, "seed": 9, "motion_scale": 0.008},
    },
}
TRACK = dict(tile_size=16, max_iters=5, tile_capacity=128, max_dup=16, opacity_threshold=0.5)
MAP = dict(tile_size=16, init_itr_num=10, iters_per_kf=2, gaussian_update_every=1000,
           prune_coviz=1, tile_capacity=128, max_dup=16)
SHADERS = ("rgb", "depth", "segmentation", "time", "ellipsoids")


@pytest.fixture(autouse=True)
def _no_frame_cache(monkeypatch):
    monkeypatch.setenv("MONOGS_SYNTH_CACHE", "0")


def _slam(tmp_path, backend="ref"):
    return SLAM(SyntheticDataset(CFG, device="cpu"),
                tracker_config=TrackerConfig(backend=backend, **TRACK),
                mapper_config=MapperConfig(backend=backend, **MAP),
                keyframe_config=KeyframeConfig(window_size=3),
                system_config=SystemConfig(map_capacity=2048, capacity_headroom=128,
                                           eval_every=0, save_dir=str(tmp_path)),
                device="cpu")


def _get(url):
    with urllib.request.urlopen(url, timeout=60) as r:
        return r.status, r.headers.get("Content-Type"), r.read()


def test_viewer_packets_latest_slot():
    s = LatestSlot()
    assert s.get() is None
    s.put(1)
    s.put(2)
    assert s.get() == 2


def test_viewer_serves_pages_and_renders(tmp_path):
    slam = _slam(tmp_path)
    viewer = slam.start_viewer(port=0)
    base = f"http://127.0.0.1:{viewer.port}"
    try:
        slam.process_frame(0)
        slam.process_frame(1)

        code, ctype, body = _get(f"{base}/")
        assert code == 200 and b"monogs_torch viewer" in body
        code, ctype, body = _get(f"{base}/state")
        assert code == 200 and json.loads(body)["frame"] == 1

        for shader in SHADERS:
            code, ctype, body = _get(f"{base}/render?follow=1&shader={shader}")
            assert code == 200 and ctype == "image/png", shader
            assert body[:8] == b"\x89PNG\r\n\x1a\n", shader
            assert len(body) > 500, shader           # an actual rendered image
            assert decode_png(body).shape == (48, 64, 3), shader

        code, ctype, body = _get(f"{base}/input")
        assert code == 200 and body[:8] == b"\x89PNG\r\n\x1a\n"
        assert decode_png(body).shape == (48, 3 * 64, 3)   # rgb | depth | segmentation

        st = json.loads(_get(f"{base}/state")[2])
        assert st["kfs"], st
        kf0 = st["kfs"][0]
        code, ctype, body = _get(f"{base}/render?kf={kf0}&shader=rgb")
        assert code == 200 and body[:8] == b"\x89PNG\r\n\x1a\n"
        shot = json.loads(_get(f"{base}/screenshot?kf={kf0}&shader=rgb")[2])["path"]
        assert os.path.exists(shot) and os.path.getsize(shot) > 500

        _get(f"{base}/pause?on=1")
        assert viewer.paused
        _get(f"{base}/pause?on=0")
        assert not viewer.paused

        with pytest.raises(urllib.error.HTTPError) as exc:
            _get(f"{base}/nope")
        assert exc.value.code == 404
    finally:
        viewer.stop()


def test_render_fn_matches_jax(tmp_path):
    """One state in both packages (JAX's SLAM after 2 frames, carried across
    with utils/convert.slam_from_numpy): the port's render_fn on the slab
    path's CPU twins against JAX's on its Pallas kernels (interpreted), in
    every shader, for the followed camera, an orbit and a keyframe view at
    the default width, and the orbit at max_width 32 (a downscaled view)."""
    from monogs_tpu.data.synthetic import SyntheticDataset as JDataset
    from monogs_tpu.slam.keyframes import KeyframeConfig as JKeyframeConfig
    from monogs_tpu.slam.mapper import MapperConfig as JMapperConfig
    from monogs_tpu.slam.system import SLAM as JSLAM
    from monogs_tpu.slam.tracker import TrackerConfig as JTrackerConfig
    from monogs_tpu.utils.config import SystemConfig as JSystemConfig
    from monogs_tpu.viewer.server import ViewerServer as JViewerServer
    from monogs_tpu.viewer.server import make_render_fn as j_make_render_fn
    from monogs_torch.utils.convert import slam_from_numpy
    from monogs_torch.viewer.server import ViewerServer

    jslam = JSLAM(JDataset(CFG), tracker_config=JTrackerConfig(backend="ref", **TRACK),
                  mapper_config=JMapperConfig(backend="ref", **MAP),
                  keyframe_config=JKeyframeConfig(window_size=3),
                  system_config=JSystemConfig(map_capacity=2048, capacity_headroom=128,
                                              eval_every=0))
    jslam.process_frame(0)
    jslam.process_frame(1)
    tslam = slam_from_numpy(jslam, _slam(tmp_path, backend="slab"), device="cpu")
    # The renders on the production paths: JAX's Pallas kernels, the
    # port's slab twins (render_fn reads the backend at each call).
    jslam.mcfg = dataclasses.replace(jslam.mcfg, backend="pallas")
    assert tslam.mcfg.backend == "slab"

    # The views as the server builds them from a packet: the followed
    # camera, an orbit off it, and the keyframe's pose.
    pkt = type("Pkt", (), {"cur_pose": tslam.est_poses[1], "kf_poses": {
        i: tslam.est_poses[i] for i in tslam.kf_list}})()
    orbit = {"yaw": "0.2", "pitch": "-0.1", "dist": "0.3", "panx": "0.05", "pany": "-0.02"}
    views = {"follow": {"follow": "1"}, "orbit": orbit, "kf": {"kf": str(tslam.kf_list[0])}}
    t_server = ViewerServer(None)
    j_server = JViewerServer(None)
    for width, names in ((480, views), (32, ["orbit"])):
        j_fn, t_fn = j_make_render_fn(jslam, max_width=width), make_render_fn(tslam, width)
        for vname in names:
            q = views[vname]
            R, t = t_server._orbit_pose(pkt, q)
            Rj, tj = j_server._orbit_pose(pkt, q)
            np.testing.assert_allclose(R, Rj, atol=1e-6)
            np.testing.assert_allclose(t, tj, atol=1e-6)
            for shader in SHADERS:
                img_j, intr_j = j_fn(Rj, tj, shader)
                img_t, intr_t = t_fn(R, t, shader)
                img_j = np.asarray(img_j)
                assert tuple(intr_t) == tuple(intr_j), (width, vname, shader)
                assert img_t.shape == img_j.shape == (intr_j.height, intr_j.width, 3)
                tol = 1e-4 if shader == "depth" else 1e-5
                np.testing.assert_allclose(img_t, img_j, atol=tol,
                                           err_msg=f"{width} {vname} {shader}")
                if shader == "segmentation":
                    assert not np.allclose(img_t, t_fn(R, t, "rgb")[0])


def test_paused_viewer_blocks_the_frame_loop(tmp_path):
    slam = _slam(tmp_path)
    viewer = slam.start_viewer(port=0)
    try:
        slam.process_frame(0)
        viewer.control.paused = True
        done = threading.Event()
        loop = threading.Thread(target=lambda: (slam.process_frame(1), done.set()),
                                daemon=True)
        loop.start()
        deadline = time.monotonic() + 60
        while 1 not in slam.est_poses and time.monotonic() < deadline:
            time.sleep(0.05)
        time.sleep(0.5)
        assert not done.is_set() and 1 in slam.est_poses   # tracked, then held
        assert viewer.slot.get() is None      # frame 0 pushes none, frame 1 waits
        _get(f"http://127.0.0.1:{viewer.port}/pause?on=0")
        assert done.wait(timeout=60)
        loop.join(timeout=10)
        assert not loop.is_alive()
        assert viewer.slot.get().cur_frame_idx == 1
    finally:
        viewer.control.paused = False
        viewer.stop()
