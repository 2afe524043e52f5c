"""track_grad_err's measure: each frame's gap over the larger of its own
reference norm and the window's median, so a frame whose gradient is all
but zero does not read its rounding as a large error, and an error in
every frame still reads at its size."""

import torch

from slambench.correctness import grad_gap


def _frames(scales):
    g = torch.Generator().manual_seed(5)
    return [{"rho": s * torch.randn(3, generator=g), "theta": s * torch.randn(3, generator=g)}
            for s in scales]


def test_small_gradient_frame_reads_its_gap_over_the_median():
    refs = _frames([1.0, 1.0, 0.01, 1.0, 1.0])
    bump = torch.full((3,), 1e-3)
    ports = [(r["rho"] + bump, r["theta"] + bump) for r in refs]
    got = grad_gap(ports, refs)
    own = max(float(torch.linalg.vector_norm(bump) / torch.linalg.vector_norm(r[k]))
              for r in refs for k in ("rho", "theta"))
    assert got < 0.01 < own, (got, own)


def test_error_in_every_frame_reads_at_its_size():
    refs = _frames([1.0, 0.5, 2.0])
    ports = [(1.1 * r["rho"], 0.9 * r["theta"]) for r in refs]
    assert abs(grad_gap(ports, refs) - 0.1) < 1e-6
