"""(B, N, C) row-major -> (B, C, N) channel-major transpose, in Triton.

Replaces the TPU kernel `_relayout_kernel` / `rows_to_channels` in
monogs_tpu/ops/tile_raster.py, both as it is called on one (N, 16) array
(`_pfs_bwd`, the tracking path) and as `jax.vmap(rows_to_channels)` over the
mapping window's (Wn, N, 16) gradients (`_pfw_bwd`). The plain PyTorch twin
is `_rows_to_channels_plain` in monogs_torch/ops/tile_raster.py and the
launcher is `rows_to_channels` in monogs_torch/ops/kernels.py.

What bounds it on the H100: bytes. It moves each float once in and once
out (12.8 MB at N = 100,000, C = 16; 134 MB at B = 8, N = 131,072) and
computes nothing.

Design: one program per BLOCK rows of one batch entry; the grid's second
axis runs over the batch, so a whole window is one launch (a 2-D input is
a batch of one). A masked block load reads the rows contiguously, `tl.trans`
turns the (BLOCK, C) tile into (C, BLOCK) in registers and shared memory,
and a masked block store writes C contiguous runs, so both sides coalesce;
the mask covers the ragged final block.

This file is a kernel source, loaded by path at first use: it imports
`triton`, which only the machine with the card has.
"""

import triton
import triton.language as tl


@triton.jit
def rows_to_channels_kernel(x_ptr, o_ptr, N, C: tl.constexpr, BLOCK: tl.constexpr):
    base = tl.program_id(1).to(tl.int64) * N * C
    rows = tl.program_id(0) * BLOCK + tl.arange(0, BLOCK)
    cols = tl.arange(0, C)
    x = tl.load(x_ptr + base + rows[:, None] * C + cols[None, :],
                mask=rows[:, None] < N, other=0.0)
    tl.store(o_ptr + base + cols[:, None] * N + rows[None, :], tl.trans(x),
             mask=rows[None, :] < N)
