"""The plain reference agrees with the program on the CPU, where the
program runs its kernels' plain twins: a render, the tracking gradient
and a mapping gradient at a small size. (The reference imports nothing of
the program; this test imports both to compare them.)"""

import numpy as np
import pytest
import torch

from slambench.reference import losses as rl
from slambench.reference import render as rr


def _scene(n=400, seed=3):
    g = torch.Generator().manual_seed(seed)
    xyz = torch.rand((n, 3), generator=g) * torch.tensor([2.0, 1.5, 1.0]) \
        - torch.tensor([1.0, 0.75, -1.5])
    params = {"xyz": xyz, "rgb": torch.rand((n, 3), generator=g),
              "log_scales": torch.log(0.02 + 0.05 * torch.rand((n, 3), generator=g)),
              "quats": torch.randn((n, 4), generator=g) + torch.tensor([2.0, 0, 0, 0]),
              "opacity_logit": torch.randn((n,), generator=g) + 1.0}
    return params, torch.ones(n, dtype=torch.bool)


CAM = rr.Camera(60.0, 60.0, 32.0, 24.0, 64, 48)


@pytest.mark.parametrize("iso, max_dup, tile_capacity", [(False, 64, 512), (True, 64, 512),
                                                          (False, 2, 128)])
def test_render_matches_program(iso, max_dup, tile_capacity):
    """The reference lists every entry: it matches the program where the
    program's caps drop nothing, and is told apart from it where they drop
    entries (max_dup 2, tile_capacity 128)."""
    from monogs_torch.models import gaussian_map as gm
    from monogs_torch.ops.graphics import Intrinsics
    from monogs_torch.ops.render import render

    params, active = _scene()
    params["log_scales"] = params["log_scales"] + (0.0 if max_dup > 2 else 1.0)
    R, t = torch.eye(3), torch.zeros(3)
    img = rl.render_at(params, active, iso, R, t, CAM, 16)
    out = render(params["xyz"], gm.get_scales(params, iso), params["quats"],
                 gm.get_opacity(params).reshape(-1), params["rgb"], R, t,
                 Intrinsics(*CAM), tile_size=16, tile_capacity=tile_capacity, max_dup=max_dup,
                 max_dup_gen=64)
    exact = max_dup > 2
    assert (int(out.overflow) == 0) == exact
    port = torch.cat([out.rgb, out.depth[..., None], out.opacity[..., None]], -1)
    gap = float(torch.linalg.vector_norm(port - img) / torch.linalg.vector_norm(img))
    assert gap < 1e-5 if exact else gap > 1e-2, gap


def test_tracking_gradient_matches_program():
    from monogs_torch.ops.graphics import Intrinsics
    from monogs_torch.slam import tracker
    from monogs_torch.slam.camera import make_frame

    params, active = _scene()
    R, t = torch.eye(3), torch.zeros(3)
    img = rl.render_at(params, active, False, R, t, CAM, 16)
    gt = {"rgb": img[..., :3].clamp(0, 1), "depth": img[..., 3] / img[..., 4].clamp_min(1e-6),
          "mask": img[..., 4] > 0.5}
    pose = np.eye(4, dtype=np.float32)
    pose[:3, 3] = [0.01, -0.02, 0.015]
    frame = make_frame(1, gt["rgb"], gt["depth"], pose, mask=gt["mask"], device="cpu")
    got = {}
    orig = tracker._adam4_update

    def keep(grads, *a, **k):
        got.setdefault("g", grads)
        return orig(grads, *a, **k)

    tracker._adam4_update = keep
    try:
        cfg = tracker.TrackerConfig(max_iters=1, tile_size=16, tile_capacity=512, max_dup=64,
                                    max_dup_gen=64, exposure_reg=0.1)
        tracker.track_frame(params, active, frame, Intrinsics(*CAM), cfg)
    finally:
        tracker._adam4_update = orig
    ref = rl.tracking_grads(params, active, False, gt, frame.R, frame.t, 0.0, 0.0, CAM, 16,
                            exposure_reg=0.1)
    for i, k in enumerate(("rho", "theta", "ea", "eb")):
        d = torch.linalg.vector_norm(got["g"][i] - ref[k]) / torch.linalg.vector_norm(ref[k])
        assert d < 1e-4, (k, float(d))


def test_lower_precision_is_told_apart():
    params, active = _scene()
    R, t = torch.eye(3), torch.zeros(3)
    a = rl.render_at(params, active, False, R, t, CAM, 16, precision="fp32")
    b = rl.render_at(params, active, False, R, t, CAM, 16, precision="bf16")
    assert torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(a) > 1e-3
