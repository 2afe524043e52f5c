"""monogs_torch's dataset parsers against monogs_tpu's on the CPU.

Each parser reads the same on-disk fixture, written the way
tests/test_datasets.py writes it (with copies of its writers, through
OpenCV), in both packages; every frame key (rgb, depth, pose, mask,
segmentation), the length and the intrinsics must be equal with
`assert_array_equal`: the same bytes through the same numpy arithmetic
give the same floats, the PNGs decoded by the port's own codec and by
OpenCV in the JAX package. RealSense runs both packages' classes on one
fake pyrealsense2 module. The stereo synthetic rig's left and right
renders agree to 1e-5 (rgb, each package's rasterizer), and fed the same
uint8 pair both pipelines give the same SGBM depth and mask, bit for bit.
`write_tum_fixture` writes what scripts/make_tum_fixture.py writes, and the
port's TUM parser reads back the quantised frames exactly and the poses to
1e-5. The frame prefetcher (the port of tests/test_datasets.py:101).
"""

import copy
import importlib.util
import json
import os
import sys
import types

import numpy as np
import pytest
import torch

from monogs_torch.data import load_dataset as t_load

cv2 = pytest.importorskip("cv2")
from monogs_tpu.data import load_dataset as j_load  # noqa: E402

torch.set_num_threads(2)   # the test workers share the CPUs (tests/test_torch_system.py)

KEYS = ("rgb", "depth", "pose", "mask", "segmentation")


# -- tests/test_datasets.py's fixture writers ----------------------------------


def _write_tum_fixture(root, n=4, w=64, h=48):
    os.makedirs(f"{root}/rgb", exist_ok=True)
    os.makedirs(f"{root}/depth", exist_ok=True)
    rgb_lines, depth_lines, gt_lines = [], ["# depth"], ["# ground truth"]
    rng = np.random.RandomState(0)
    for i in range(n):
        t = 100.0 + i * 0.05
        img = (rng.rand(h, w, 3) * 255).astype(np.uint8)
        cv2.imwrite(f"{root}/rgb/{t:.6f}.png", img)
        depth = (rng.uniform(0.5, 3.0, (h, w)) * 5000).astype(np.uint16)
        cv2.imwrite(f"{root}/depth/{t:.6f}.png", depth)
        rgb_lines.append(f"{t:.6f} rgb/{t:.6f}.png")
        depth_lines.append(f"{t + 0.01:.6f} depth/{t:.6f}.png")
        gt_lines.append(f"{t + 0.005:.6f} {0.01 * i:.4f} 0.0 0.0 0.0 0.0 0.0 1.0")
    with open(f"{root}/rgb.txt", "w") as f:
        f.write("# rgb\n" + "\n".join(rgb_lines) + "\n")
    with open(f"{root}/depth.txt", "w") as f:
        f.write("\n".join(depth_lines) + "\n")
    with open(f"{root}/groundtruth.txt", "w") as f:
        f.write("\n".join(gt_lines) + "\n")


def _tum_config(root, w=64, h=48):
    return {"Dataset": {"type": "tum", "dataset_path": root, "Calibration": {
        "fx": 50.0, "fy": 50.0, "cx": w / 2, "cy": h / 2, "width": w, "height": h,
        "depth_scale": 5000.0, "distorted": False}}}


def _write_replica_fixture(root, n=3, w=64, h=48):
    os.makedirs(f"{root}/results", exist_ok=True)
    rng = np.random.RandomState(1)
    trajs = []
    for i in range(n):
        img = (rng.rand(h, w, 3) * 255).astype(np.uint8)
        cv2.imwrite(f"{root}/results/frame{i:06d}.jpg", img)
        depth = (rng.uniform(0.5, 3.0, (h, w)) * 6553.5).astype(np.uint16)
        cv2.imwrite(f"{root}/results/depth{i:06d}.png", depth)
        T = np.eye(4)
        T[0, 3] = 0.02 * i  # c2w
        trajs.append(" ".join(str(x) for x in T.reshape(-1)))
    with open(f"{root}/traj.txt", "w") as f:
        f.write("\n".join(trajs) + "\n")


def _replica_config(root):
    return {"Dataset": {"type": "replica", "dataset_path": root, "Calibration": {
        "fx": 50.0, "fy": 50.0, "cx": 32.0, "cy": 24.0, "width": 64, "height": 48,
        "depth_scale": 6553.5}}}


def _write_euroc_fixture(root, n=3, w=192, h=96, disp=8):
    """EuRoC's mav0 layout; the right image is the left shifted `disp` px."""
    os.makedirs(f"{root}/mav0/cam0/data", exist_ok=True)
    os.makedirs(f"{root}/mav0/cam1/data", exist_ok=True)
    os.makedirs(f"{root}/mav0/state_groundtruth_estimate0", exist_ok=True)
    rng = np.random.RandomState(7)
    base = cv2.GaussianBlur((rng.rand(h, w + disp) * 255).astype(np.uint8), (0, 0), 1.0)
    rows = ["#timestamp, p_x, p_y, p_z, q_w, q_x, q_y, q_z, ..."]
    for i in range(n):
        ts = 1000000 + i * 50000
        cv2.imwrite(f"{root}/mav0/cam0/data/{ts}.png", base[:, :-disp])
        cv2.imwrite(f"{root}/mav0/cam1/data/{ts}.png", base[:, disp:])
        rows.append(f"{ts},{0.01 * i},0.0,0.0,1.0,0.0,0.0,0.0,0,0,0,0,0,0,0,0")
    with open(f"{root}/mav0/state_groundtruth_estimate0/data.csv", "w") as f:
        f.write("\n".join(rows) + "\n")


def _euroc_config(root, w=192, h=96):
    cam = {"fx": 80.0, "fy": 80.0, "cx": w / 2, "cy": h / 2}
    raw = dict(cam, k1=0.0, k2=0.0, p1=0.0, p2=0.0, k3=0.0)
    eye = {"data": [1.0, 0, 0, 0, 1.0, 0, 0, 0, 1.0]}
    return {"Dataset": {"type": "euroc", "dataset_path": root, "Calibration": {
        "width": w, "height": h, "depth_scale": 1.0,
        "cam0": {"raw": raw, "opt": dict(cam), "R": eye},
        "cam1": {"raw": raw, "opt": dict(cam), "R": eye}}}}


def _write_kubric_fixture(root, n=3, w=64, h=48):
    for sub in ("rgba", "depth", "segmentation"):
        os.makedirs(f"{root}/{sub}", exist_ok=True)
    rng = np.random.RandomState(2)
    positions, quaternions = [], []
    for i in range(n):
        cv2.imwrite(f"{root}/rgba/rgba_{i:05d}.png", (rng.rand(h, w, 4) * 255).astype(np.uint8))
        cv2.imwrite(f"{root}/depth/depth_{i:05d}.tiff",
                    rng.uniform(0.5, 3.0, (h, w)).astype(np.float32))
        seg = np.zeros((h, w), np.uint8)
        seg[h // 2:, :] = 1
        cv2.imwrite(f"{root}/segmentation/segmentation_{i:05d}.png", seg)
        positions.append([0.02 * i, 0.0, 0.0])
        quaternions.append([1.0, 0.0, 0.0, 0.0])
    with open(f"{root}/metadata.json", "w") as f:
        json.dump({"camera": {"positions": positions, "quaternions": quaternions}}, f)


def _kubric_config(root):
    return {"Dataset": {"type": "kubric", "dataset_path": root, "Calibration": {
        "fx": 50.0, "fy": 50.0, "cx": 32.0, "cy": 24.0, "width": 64, "height": 48,
        "depth_scale": 1.0}, "Objects": {"static": [0], "dynamic": [1], "masked": [1]}}}


def _write_davis_fixture(root, n=3, w=64, h=48):
    os.makedirs(f"{root}/rgb", exist_ok=True)
    os.makedirs(f"{root}/segmentation", exist_ok=True)
    rng = np.random.RandomState(3)
    for i in range(n):
        cv2.imwrite(f"{root}/rgb/{i:05d}.jpg", (rng.rand(h, w, 3) * 255).astype(np.uint8))
        seg = np.zeros((h, w), np.uint8)
        seg[:, : w // 2] = 2
        cv2.imwrite(f"{root}/segmentation/{i:05d}.png", seg)


def _davis_config(root):
    return {"Dataset": {"type": "davis", "dataset_path": root, "Calibration": {
        "fx": 50.0, "fy": 50.0, "cx": 32.0, "cy": 24.0, "width": 64, "height": 48},
        "Objects": {"static": [0], "dynamic": [2], "masked": [2]}}}


FIXTURES = {
    "tum": (_write_tum_fixture, _tum_config),
    "replica": (_write_replica_fixture, _replica_config),
    "euroc": (_write_euroc_fixture, _euroc_config),
    "kubric": (_write_kubric_fixture, _kubric_config),
    "davis": (_write_davis_fixture, _davis_config),
}


@pytest.fixture(scope="module")
def fixture_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("datasets")
    for name, (write, _) in FIXTURES.items():
        write(str(root / name))
    return root


def _host(v):
    return v.cpu().numpy() if torch.is_tensor(v) else np.asarray(v)


def _assert_same(ft: dict, fj: dict):
    for k in KEYS:
        if fj[k] is None:
            assert ft[k] is None, k
            continue
        a, b = _host(ft[k]), _host(fj[k])
        assert a.dtype == b.dtype, (k, a.dtype, b.dtype)
        np.testing.assert_array_equal(a, b, err_msg=k)


def _assert_datasets_equal(td, jd):
    assert len(td) == len(jd) > 0
    assert tuple(td.intrinsics) == tuple(jd.intrinsics)
    assert td.has_depth == jd.has_depth and td.nr_objects == jd.nr_objects
    for i in range(len(jd)):
        _assert_same(td[i], jd[i])


@pytest.mark.parametrize("name", list(FIXTURES))
def test_parser_matches_jax(fixture_root, name):
    cfg = FIXTURES[name][1](str(fixture_root / name))
    td = t_load(copy.deepcopy(cfg), device="cpu")
    jd = j_load(copy.deepcopy(cfg))
    assert type(td).__name__ == type(jd).__name__
    _assert_datasets_equal(td, jd)
    if name == "kubric":       # the masked object's pixels leave the loss mask
        f = td[1]
        assert set(np.unique(f["segmentation"])) == {0, 1}
        assert not f["mask"][40, 10] and f["mask"][5, 10]


@pytest.mark.parametrize("preload", [True, "device"])
def test_tum_preload_matches_jax(fixture_root, preload):
    """Dataset.preload: host memory (the same frame objects each read), and
    "device", tensors on the given device (the CPU here)."""
    cfg = _tum_config(str(fixture_root / "tum"))
    cfg["Dataset"]["preload"] = preload
    td, jd = t_load(copy.deepcopy(cfg), device="cpu"), j_load(copy.deepcopy(cfg))
    assert type(td).__name__ == type(jd).__name__ == "PreloadedDataset"
    _assert_datasets_equal(td, jd)
    if preload == "device":
        assert all(torch.is_tensor(td[0][k]) and td[0][k].device.type == "cpu" for k in KEYS)
    else:
        assert td[1]["rgb"] is td[1]["rgb"]
    assert td.intrinsics.fx == 50.0       # attribute access goes to the dataset


def test_davis_colour_annotation_keeps_opencvs_first_channel(tmp_path):
    """A colour (palette) annotation: OpenCV's BGR channel 0 is blue, which
    the JAX parser keeps; the port reads RGB and must keep channel 2."""
    from PIL import Image

    _write_davis_fixture(str(tmp_path))
    idx = np.zeros((48, 64), np.uint8)
    idx[:, :32] = 1
    idx[:8] = 2
    p = Image.fromarray(idx, "P")
    p.putpalette([0, 0, 0, 10, 20, 30, 200, 100, 2] + [0] * 759)
    for i in range(3):
        p.save(tmp_path / "segmentation" / f"{i:05d}.png")
    cfg = _davis_config(str(tmp_path))
    cfg["Dataset"]["Objects"]["masked"] = [30]
    td, jd = t_load(copy.deepcopy(cfg), device="cpu"), j_load(copy.deepcopy(cfg))
    _assert_datasets_equal(td, jd)
    assert set(np.unique(td[0]["segmentation"])) == {0, 2, 30}
    assert not td[0]["mask"][20, 5] and td[0]["mask"][20, 60]


def _fake_realsense(h=24, w=32):
    """A pyrealsense2 stand-in: one pipeline streaming seeded BGR and depth
    frames, frame k from RandomState(k)."""
    ns = types.SimpleNamespace

    class Pipeline:
        def __init__(self):
            self.k = 0

        def start(self, cfg):
            intr = ns(width=w, height=h, fx=30.0, fy=31.0, ppx=15.5, ppy=11.5)
            stream = ns(as_video_stream_profile=lambda: ns(get_intrinsics=lambda: intr))
            sensor = ns(get_depth_scale=lambda: 0.001)
            return ns(get_stream=lambda s: stream,
                      get_device=lambda: ns(first_depth_sensor=lambda: sensor))

        def wait_for_frames(self):
            rng = np.random.RandomState(self.k)
            self.k += 1
            color = (rng.rand(h, w, 3) * 255).astype(np.uint8)
            depth = rng.randint(0, 4000, (h, w)).astype(np.uint16)
            return ns(get_color_frame=lambda: ns(get_data=lambda: color),
                      get_depth_frame=lambda: ns(get_data=lambda: depth))

    return types.SimpleNamespace(
        pipeline=Pipeline, config=lambda: ns(enable_stream=lambda *a, **k: None),
        stream=ns(color="color", depth="depth"), format=ns(bgr8="bgr8"),
        align=lambda s: ns(process=lambda fs: fs))


def test_realsense_matches_jax_on_a_fake_camera(monkeypatch):
    cfg = {"Dataset": {"type": "realsense", "n_frames": 3}}
    monkeypatch.setitem(sys.modules, "pyrealsense2", _fake_realsense())
    td, jd = t_load(copy.deepcopy(cfg), device="cpu"), j_load(copy.deepcopy(cfg))
    _assert_datasets_equal(td, jd)
    monkeypatch.setitem(sys.modules, "pyrealsense2", None)
    with pytest.raises(ImportError, match="pyrealsense2"):
        t_load(copy.deepcopy(cfg), device="cpu")


def test_opencv_only_parsers_raise_without_opencv(fixture_root, monkeypatch):
    """Without cv2 the TUM parser (PNG, undistorted) still loads; EuRoC
    (rectification, SGBM), Replica and DAVIS (JPEG rgb), Kubric (TIFF
    depth) and a distorted calibration fail when they are built, with an
    ImportError naming OpenCV; a frame's JPEG fails the same way."""
    monkeypatch.setitem(sys.modules, "cv2", None)
    td = t_load(_tum_config(str(fixture_root / "tum")), device="cpu")
    assert td[0]["rgb"].shape == (48, 64, 3)
    for name in ("euroc", "replica", "davis", "kubric"):
        with pytest.raises(ImportError, match="OpenCV"):
            t_load(FIXTURES[name][1](str(fixture_root / name)), device="cpu")
    cfg = _tum_config(str(fixture_root / "tum"))
    cfg["Dataset"]["Calibration"].update(distorted=True, k1=0.01)
    with pytest.raises(ImportError, match="OpenCV"):
        t_load(cfg, device="cpu")
    from monogs_torch.utils.images import read_image
    with pytest.raises(ImportError, match="JPEG.*OpenCV"):
        read_image(str(fixture_root / "replica" / "results" / "frame000000.jpg"))


# -- the stereo synthetic rig ------------------------------------------------------


def _synth_stereo_config(baseline=0.25):
    """tests/test_datasets.py's rig: 160x120, 2,000 Gaussians, 4 frames."""
    return {"Dataset": {
        "type": "synthetic", "sensor_type": "stereo",
        "Calibration": {"width": 160, "height": 120, "fx": 120.0, "fy": 120.0,
                        "cx": 80.0, "cy": 60.0, "depth_scale": 1.0},
        "Objects": {"static": [0], "dynamic": [], "masked": []},
        "synthetic": {"n_frames": 4, "n_gaussians": 2000, "seed": 3, "motion_scale": 0.01,
                      "render_tile_capacity": 512,
                      "stereo": {"baseline": baseline, "num_disparities": 32,
                                 "block_size": 9, "uniqueness_ratio": 10}}}}


def test_stereo_rig_matches_jax(monkeypatch):
    """The left and right renders agree to 1e-5 in rgb; then both packages'
    pipelines, fed the same two renders, give the same SGBM depth and mask
    bit for bit, with the disk cache apart from the JAX package's."""
    monkeypatch.setenv("MONOGS_SYNTH_CACHE", "0")
    cfg = _synth_stereo_config()
    td = t_load(copy.deepcopy(cfg), device="cpu")
    jd = j_load(copy.deepcopy(cfg))
    assert type(td).__name__ == type(jd).__name__ == "SyntheticStereoDataset"
    assert (td.baseline, td.num_disparities, td.sgbm_block_size, td.uniqueness) == (
        jd.baseline, jd.num_disparities, jd.sgbm_block_size, jd.uniqueness)
    idx = 1
    T_l = td.poses[idx]
    np.testing.assert_allclose(T_l, jd.poses[idx], atol=1e-6, rtol=0)
    renders = {}
    for eye, T in (("left", T_l), ("right", td._T_lr @ T_l)):
        rt, rj = td._render_pose(T), jd._render_pose(T)
        np.testing.assert_allclose(rt["rgb"], rj["rgb"], atol=1e-5, rtol=0, err_msg=eye)
        assert (rt["mask"] != rj["mask"]).mean() < 1e-3
        renders[eye] = rt
    assert renders["left"]["rgb"].std() > 0.05

    # One uint8-exact pair, given to both pipelines.
    feed = iter([])

    def fed(self, T, scene=None):
        return dict(next(feed))
    for ds in (td, jd):
        monkeypatch.setattr(type(ds), "_render_pose", fed)
    out = []
    for ds in (td, jd):
        feed = iter([renders["left"], renders["right"]])
        out.append(ds._render_frame(idx))
    ft, fj = out
    _assert_same(ft, fj)
    valid = ft["depth"] > 0
    assert valid.mean() > 0.25


def test_stereo_rig_needs_opencv(monkeypatch):
    monkeypatch.setenv("MONOGS_SYNTH_CACHE", "0")
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(ImportError, match="OpenCV"):
        t_load(_synth_stereo_config(), device="cpu")


# -- the TUM fixture tool ------------------------------------------------------------


def _tiny_synth(n_frames=5):
    return {"Dataset": {
        "type": "synthetic",
        "Calibration": {"width": 64, "height": 48, "fx": 50.0, "fy": 50.0, "cx": 32.0,
                        "cy": 24.0, "depth_scale": 1.0},
        "synthetic": {"n_frames": n_frames, "n_gaussians": 500, "seed": 5,
                      "motion_scale": 0.02}}}


def test_write_tum_fixture_reads_back_and_matches_the_script(tmp_path, monkeypatch):
    """The port's fixture tool against scripts/make_tum_fixture.py, both
    given the port's synthetic frames: the same text files byte for byte,
    the same pixels in the images; the port's TUM parser reads back every
    frame, quantised as the writer quantised it, exactly, and the poses to
    1e-5."""
    monkeypatch.setenv("MONOGS_SYNTH_CACHE", "0")
    from monogs_torch.data.synthetic import SyntheticDataset
    from monogs_torch.data.tum import TUMDataset, match_streams, read_stamped_table
    from monogs_torch.tools.make_tum_fixture import quantise, write_tum_fixture

    ds = SyntheticDataset(_tiny_synth(), device="cpu")
    out = tmp_path / "port"
    stats = write_tum_fixture(ds, str(out))
    assert stats["frames"] == 5 and stats["bytes"] > 0
    assert sum(stats["filters"].values()) == 2 * 5 * 48

    cfg = _tum_config(str(out))
    tum = TUMDataset(cfg)
    # The association keeps every rgb frame; the 32 Hz thinning drops those
    # under 1/32 s after the last kept (the 30 Hz stream's jitter).
    rgb_tab = read_stamped_table(str(out / "rgb.txt"))
    depth_tab = read_stamped_table(str(out / "depth.txt"))
    gt_tab = read_stamped_table(str(out / "groundtruth.txt"), skiprows=1)
    kept = match_streams(*(t[:, 0].astype(float) for t in (rgb_tab, depth_tab, gt_tab)))[0]
    assert len(kept) == 5 and 3 <= len(tum) <= 5
    names = [os.path.join(str(out), p) for p in rgb_tab[:, 1]]
    for k in range(len(tum)):
        i = names.index(tum.color_paths[k])
        f, g = tum[k], ds[i]
        rgb8, dep16 = quantise(g)
        np.testing.assert_array_equal(f["rgb"], (rgb8 / 255.0).astype(np.float32))
        np.testing.assert_array_equal(f["depth"], dep16.astype(np.float32) / 5000.0)
        np.testing.assert_allclose(f["pose"], g["pose"], atol=1e-5, rtol=0)

    # scripts/make_tum_fixture.py on the same frames.
    path = os.path.join(os.path.dirname(__file__), "..", "scripts", "make_tum_fixture.py")
    spec = importlib.util.spec_from_file_location("make_tum_fixture_script", path)
    script = importlib.util.module_from_spec(spec)
    saved = list(sys.path)
    try:
        spec.loader.exec_module(script)   # it puts a checkout path on sys.path
    finally:
        sys.path[:] = saved
    import monogs_tpu.data
    import monogs_tpu.utils.config
    monkeypatch.setattr(script, "OUT", str(tmp_path / "script"))
    monkeypatch.setattr(monogs_tpu.data, "load_dataset", lambda cfg: ds)
    monkeypatch.setattr(monogs_tpu.utils.config, "load_config", lambda path: {})
    script.main()
    for name in ("rgb.txt", "depth.txt", "groundtruth.txt"):
        assert (out / name).read_bytes() == (tmp_path / "script" / name).read_bytes(), name
    for line in (out / "rgb.txt").read_text().splitlines()[1:] + \
            (out / "depth.txt").read_text().splitlines()[1:]:
        rel = line.split()[1]
        a = cv2.imread(str(out / rel), cv2.IMREAD_UNCHANGED)
        b = cv2.imread(str(tmp_path / "script" / rel), cv2.IMREAD_UNCHANGED)
        np.testing.assert_array_equal(a, b, err_msg=rel)


def test_fixture_tool_command_line(tmp_path, monkeypatch):
    """`python -m monogs_torch.tools.make_tum_fixture DIR --config CFG
    --n-frames N --device cpu`: N frames written, which the TUM parser
    reads."""
    import yaml
    from monogs_torch.tools import make_tum_fixture as tool

    monkeypatch.setenv("MONOGS_SYNTH_CACHE", "0")
    cfg_path = tmp_path / "synth.yaml"
    cfg_path.write_text(yaml.safe_dump(_tiny_synth(3)))
    stats = tool.main([str(tmp_path / "fx"), "--config", str(cfg_path), "--n-frames", "2",
                       "--device", "cpu"])
    assert stats["frames"] == 2
    tum_cfg = _tum_config(str(tmp_path / "fx"))
    assert 1 <= len(t_load(tum_cfg, device="cpu")) <= 2


# -- the frame prefetcher (tests/test_datasets.py:101) ------------------------------------


def test_frame_prefetcher_matches_sync():
    """Sequential and random access give the right frames, and the pending
    lookaheads stay at 4 or fewer."""
    from monogs_torch.slam.system import _FramePrefetcher

    loads = []

    def load(i):
        if i >= 10:
            raise IndexError(i)
        loads.append(i)
        return {"idx": i}

    pf = _FramePrefetcher(load)
    for i in range(10):
        assert pf.get(i)["idx"] == i
        assert len(pf._pending) <= 4
    for i in [3, 7, 1, 9, 0, 5]:
        assert pf.get(i)["idx"] == i
        assert len(pf._pending) <= 4
    assert pf.get(10 - 1)["idx"] == 9
