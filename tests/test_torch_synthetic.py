"""monogs_torch's synthetic dataset against monogs_tpu's on the CPU, for the
wall scene, a small room and the wall scene with the moving object.

The scene arrays come from the same numpy draws: equal. The poses within
1e-6 (the wall trajectory goes through each package's float32 se3_exp).
The ground truth is rendered by each package's own rasterizer (the port's
slab twins, JAX's Pallas kernels in interpret mode): rgb within 1e-5 and
depth within 1e-4 (the JAX suite's raster tolerances), the coverage mask
(opacity > 0.5) equal except where the opacity lies within 1e-5 of 0.5,
the segmentation equal away from its thresholds. The disk cache is keyed
apart from the JAX package's, so a frame the JAX package cached is never
read as the port's ground truth.
"""

import copy
import os
import sys

import numpy as np
import pytest
import torch

from monogs_tpu.data import synthetic as js
from monogs_torch.data import synthetic as ts
from monogs_torch.ops.render import render

torch.set_num_threads(2)   # the test workers share the CPUs (tests/test_torch_system.py)

CALIB = {"width": 64, "height": 48, "fx": 52.0, "fy": 52.0, "cx": 32.0, "cy": 24.0,
         "depth_scale": 1.0}


def _cfg(scene="wall", n=600, frames=4, dynamic=None, masked=()):
    syn = {"n_frames": frames, "n_gaussians": n, "seed": 2, "motion_scale": 0.03,
           "scene": scene}
    if dynamic:
        syn["dynamic_object"] = dynamic
    return {"Dataset": {"type": "synthetic", "Calibration": dict(CALIB),
                        "Objects": {"static": [0], "dynamic": [], "masked": list(masked)},
                        "synthetic": syn}}


CASES = {
    "wall": _cfg(),
    "room": _cfg("room", n=2500),
    "dynamic": _cfg(dynamic={"n_gaussians": 40, "center": [0.0, 0.0, 2.0],
                             "size": 0.15, "velocity": [0.05, 0.0, 0.0]}, masked=[1]),
}


@pytest.fixture(autouse=True)
def _no_frame_cache(monkeypatch):
    monkeypatch.setenv("MONOGS_SYNTH_CACHE", "0")


def _opacity(ds, T, scene):
    """The port's opacity image of `scene` at w2c T (as the dataset renders)."""
    f32 = torch.float32
    out = render(*(torch.as_tensor(np.asarray(x), dtype=f32) for x in scene),
                 torch.as_tensor(T[:3, :3], dtype=f32), torch.as_tensor(T[:3, 3], dtype=f32),
                 ds.intrinsics, tile_capacity=ds._tile_capacity, max_dup=32)
    return out.opacity.numpy()


@pytest.mark.parametrize("case", list(CASES))
def test_synthetic_frames_match_jax(case):
    cfg = CASES[case]
    jd, td = js.SyntheticDataset(copy.deepcopy(cfg)), ts.SyntheticDataset(
        copy.deepcopy(cfg), device="cpu")
    for a, b in zip(td.scene, jd.scene):
        np.testing.assert_array_equal(a, b)
    assert len(td) == len(jd) == 4
    for idx in (0, 3):
        np.testing.assert_allclose(td.poses[idx], jd.poses[idx], atol=1e-6, rtol=0)
        ft, fj = td[idx], jd[idx]
        np.testing.assert_array_equal(ft["pose"], td.poses[idx].astype(np.float32))
        np.testing.assert_allclose(ft["rgb"], fj["rgb"], atol=1e-5, rtol=0)
        scene, obj = td._scene_at(idx)
        opa = _opacity(td, td.poses[idx], scene)
        near_half = np.abs(opa - 0.5) <= 1e-5
        cov_t, cov_j = opa > 0.5, np.asarray(jd._render_frame(idx)["mask"])
        assert ((cov_t != cov_j) <= near_half).all()
        both = cov_t & cov_j
        assert both.mean() > 0.3
        np.testing.assert_allclose(ft["depth"][both], fj["depth"][both], atol=1e-4, rtol=0)
        if obj is None:
            np.testing.assert_array_equal(ft["mask"], cov_t)
            continue
        # The moving object: segmentation, and the masked object's pixels
        # out of the loss mask.
        seg_t, seg_j = ft["segmentation"], fj["segmentation"]
        assert seg_t.sum() > 0
        only = _opacity(td, td.poses[idx], obj)
        edge = (np.abs(only - 0.5) <= 1e-5) | near_half
        assert ((seg_t != seg_j) <= edge).all()
        np.testing.assert_array_equal(ft["mask"], cov_t & (seg_t != 1))


def test_the_disk_cache_is_not_shared_with_jax(tmp_path, monkeypatch):
    """A frame the JAX package cached (here poisoned, to tell it apart) is
    not read by the port, even from the same cache root; the port's own
    cache round-trips its render."""
    monkeypatch.setenv("MONOGS_SYNTH_CACHE", "1")
    monkeypatch.setenv("MONOGS_SYNTH_CACHE_DIR", str(tmp_path))
    cfg = CASES["wall"]
    jd = js.SyntheticDataset(copy.deepcopy(cfg))
    jd[0]
    jframe = tmp_path / jd._disk_cache.split("/")[-1] / "frame_00000.npz"
    assert jframe.exists()
    z = dict(np.load(jframe))
    np.savez(jframe, **{k: np.zeros_like(v) for k, v in z.items()})

    td = ts.SyntheticDataset(copy.deepcopy(cfg), device="cpu")
    assert td._disk_cache != jd._disk_cache
    assert td._disk_cache.startswith(str(tmp_path))
    rgb = td[0]["rgb"]
    assert rgb.max() > 0.1
    np.testing.assert_allclose(rgb, z["rgb"], atol=1e-5, rtol=0)
    again = ts.SyntheticDataset(copy.deepcopy(cfg), device="cpu")[0]
    for k in ("rgb", "depth", "mask", "segmentation"):
        np.testing.assert_array_equal(again[k], td[0][k])

    monkeypatch.delenv("MONOGS_SYNTH_CACHE_DIR")
    assert ts.cache_root() != os.path.expanduser("~/.cache/monogs_synth")


def test_load_dataset_preloads_and_refuses_what_is_not_ported(monkeypatch):
    """Dataset.preload "device" places every frame's arrays on the given
    device (here the CPU) as tensors. What cannot load fails loudly: an
    unknown dataset type (ValueError, misspelt or absent), and the stereo
    sensor where OpenCV (its rectification and SGBM) is missing
    (ImportError naming OpenCV)."""
    from monogs_torch.data import load_dataset

    cfg = copy.deepcopy(CASES["wall"])
    cfg["Dataset"]["preload"] = "device"
    ds = load_dataset(cfg, device="cpu")
    plain = ts.SyntheticDataset(copy.deepcopy(CASES["wall"]), device="cpu")
    assert len(ds) == 4 and ds.intrinsics == plain.intrinsics
    for k in ("rgb", "depth", "pose", "mask", "segmentation"):
        assert torch.is_tensor(ds[2][k])
        np.testing.assert_array_equal(ds[2][k].numpy(), plain[2][k])
    for bad in ({"Dataset": {"type": "nope"}}, {"Dataset": {"type": "TUM"}}):
        with pytest.raises(ValueError, match="Unknown dataset type"):
            load_dataset(bad, device="cpu")
    stereo = copy.deepcopy(CASES["wall"])
    stereo["Dataset"]["sensor_type"] = "stereo"
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(ImportError, match="OpenCV"):
        load_dataset(stereo, device="cpu")
