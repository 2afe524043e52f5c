"""monogs_torch's moving objects through `SLAM` on the CPU (the port of
tests/test_dynamic.py:85 and :116): the synthetic dataset's moving object
in rgb and segmentation, moving across frames, and out of the loss mask
when masked; and, unmasked, its pixels seeding Gaussians whose obj_prob
carries the object's channel after 4 frames. The second half of :116, the
viewer's segmentation shader, waits for the viewer's port (ROADMAP Queue 1
item 13b). The masked run against the static one (:100) is
tests/test_torch_dynamic_masked.py: each SLAM run has a worker of its own.
"""

import copy

import numpy as np
import pytest
import torch

from monogs_torch.data.synthetic import SyntheticDataset
from monogs_torch.slam import system as tsys
from test_torch_system import CFG, _configs

torch.set_num_threads(2)   # the test workers share the CPUs (tests/test_torch_system.py)

# A red blob crossing the view (tests/test_dynamic.py's DYN_OBJ).
DYN_OBJ = {"n_gaussians": 120, "center": [0.45, 0.0, 2.0], "size": 0.14,
           "velocity": [-0.06, 0.0, 0.0]}


@pytest.fixture(autouse=True)
def _isolated_cache(tmp_path, monkeypatch):
    """A frame cache of the test's own (tests/test_dynamic.py's guard: the
    loss mask depends on Objects, which the cache key must carry)."""
    monkeypatch.setenv("MONOGS_SYNTH_CACHE_DIR", str(tmp_path / "cache"))


def dyn_cfg(masked: bool) -> dict:
    """tests/test_dynamic.py's scene (tests/test_slam_e2e.py's CFG, which
    tests/test_torch_system.py carries) with the moving object."""
    cfg = copy.deepcopy(CFG)
    cfg["Dataset"]["synthetic"]["dynamic_object"] = dict(DYN_OBJ)
    cfg["Dataset"]["Objects"] = {"static": [0], "dynamic": [1],
                                 "masked": [1] if masked else []}
    return cfg


def make_slam(cfg):
    """tests/test_dynamic.py's `_make_slam`: the e2e budgets, the dense
    oracle."""
    return tsys.SLAM(SyntheticDataset(cfg, device="cpu"), **_configs("torch", "ref"),
                     device="cpu")


def test_dynamic_object_renders_and_masks():
    ds = SyntheticDataset(dyn_cfg(masked=True), device="cpu")
    d0, d4 = ds[0], ds[4]
    seg0, seg4 = np.asarray(d0["segmentation"]), np.asarray(d4["segmentation"])
    assert seg0.max() == 1 and seg4.max() == 1, "object not in view"
    moved = np.logical_xor(seg0 == 1, seg4 == 1).sum()
    assert moved > 0.3 * max((seg0 == 1).sum(), 1)
    assert not (np.asarray(d0["mask"]) & (seg0 == 1)).any()


def test_unmasked_dynamic_object_populates_obj_prob():
    slam = make_slam(dyn_cfg(masked=False))
    for i in range(4):
        slam.process_frame(i)
    gmap = slam.state.gmap
    assert gmap.obj_prob.shape[1] == 2
    n_obj = int(((gmap.obj_prob[:, 1] > 0.5) & gmap.active).sum())
    assert n_obj > 5, f"only {n_obj} Gaussians carry obj channel 1"
    # One-hots: every active Gaussian carries exactly one object.
    act = gmap.obj_prob[gmap.active]
    assert torch.equal(act.sum(1), torch.ones(act.shape[0]))
