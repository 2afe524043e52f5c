"""K-nearest-neighbour mean squared distance (port of monogs_tpu/ops/knn.py).

For each point, the mean squared distance to its k nearest valid
neighbours, which seeds new Gaussians' scales. A blocked pairwise-distance
computation: |a - b|^2 = |a|^2 - 2 a.b + |b|^2 with the cross term one
matrix product per block of rows, then k rounds of min-extraction (each
round removes every entry <= the row's minimum, the JAX tie rule). Masked
points neither serve as neighbours nor receive distances.

The cross term is a plain float32 `torch.matmul`, as the JAX package
leaves it to XLA. On the card it runs in full float32 unless a caller has
turned `torch.backends.cuda.matmul.allow_tf32` on; this module sets no
global flag.
"""

from __future__ import annotations

import torch

_BIG = 1e10


def knn_mean_sq_dist(points: torch.Tensor, mask: torch.Tensor | None = None,
                     k: int = 3, block: int = 1024) -> torch.Tensor:
    """(N, 3) points, (N,) bool mask -> (N,) mean squared distance to the k
    nearest valid neighbours (0 for masked points)."""
    N = points.shape[0]
    if mask is None:
        mask = torch.ones(N, dtype=torch.bool, device=points.device)
    sq = torch.sum(points * points, dim=-1)
    col = torch.arange(N, device=points.device)[None, :]
    out = torch.empty(N, dtype=points.dtype, device=points.device)
    for s in range(0, N, block):
        if not points.is_cuda and not bool(mask[s:s + block].any()):
            # A block of masked rows only gets 0s. Skipped on the host alone,
            # where the test costs no device sync: an extend event's
            # candidates (max_new of them) are mostly masked.
            out[s:s + block] = 0.0
            continue
        rows = points[s:s + block]
        cross = rows @ points.T                                   # (B, N)
        d2 = sq[s:s + block, None] - 2.0 * cross + sq[None, :]
        row_ids = s + torch.arange(rows.shape[0], device=points.device)[:, None]
        d2 = torch.where((col == row_ids) | ~mask[None, :],
                         torch.full_like(d2, _BIG), d2)
        d2 = torch.clamp_min(d2, 0.0)
        total = torch.zeros(rows.shape[0], dtype=d2.dtype, device=d2.device)
        for _ in range(k):
            m = torch.amin(d2, dim=1)
            total = total + m
            d2 = torch.where(d2 <= m[:, None], torch.full_like(d2, _BIG), d2)
        out[s:s + block] = torch.where(mask[s:s + block], total / k,
                                       torch.zeros_like(total))
    return out
