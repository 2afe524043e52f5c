"""The sharded mapping iteration (port of monogs_tpu/parallel/overlap.py).

The JAX package writes it with shard_map and leaves the overlap of the
gradient collectives with the backward to XLA's scheduler. Here each step
is an explicit collective, issued in one order on every rank:

- each rank renders and differentiates its slots of the keyframe window
  (`slam/mapper.py::_forward_backward`, the unsharded iteration's own);
- the map leaves' masked gradients, packed side by side, are
  reduce-scattered to the ZeRO rows in one collective once the backward
  has returned;
- the loss sums over the ranks; the densification statistics too (sums
  for xyz_grad_accum and denom, a max for max_radii2d);
- Adam steps the rank's rows only (`models/optim.adam_step`), and the
  parameter rows, packed, are all-gathered back into the whole map in one
  collective;
- the pose Adam steps the rank's own keyframes; the isotropic term, a
  whole-map term every rank adds, counts 1 / n.

On a two-level mesh the reduce-scatter runs within the host and the rows'
sums are then all-reduced across hosts. At world size 1 every collective
is a copy, and the iteration is `_mapping_iter` bit for bit.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..models.optim import adam_step
from ..slam.mapper import (
    MapperState,
    MappingAux,
    _densify_parts,
    _forward_backward,
    _mask_active,
    _pose_step,
)
from .mesh import Mesh, all_gather_rows, pack_rows, unpack_rows


def _sum_grad_rows(mesh: Mesh, active: torch.Tensor, grads: dict,
                   rows: tuple[int, int]) -> dict:
    """Every leaf's masked gradient summed over the ranks, this rank's
    Adam rows only: one reduce-scatter of the packed leaves over the ZeRO
    group (then, on a two-level mesh, one all-reduce of the rows across
    hosts), or one all-reduce of every row when they are not divided."""
    packed = pack_rows({k: _mask_active(active, g) for k, g in grads.items()})
    if packed.shape[0] % mesh.zero_size:
        dist.all_reduce(packed, group=mesh.group)
        return unpack_rows(packed, grads)
    out = packed.new_empty((rows[1] - rows[0], packed.shape[1]))
    dist.reduce_scatter_tensor(out, packed, group=mesh.zero_group)
    if mesh.cross_group is not None:
        dist.all_reduce(out, group=mesh.cross_group)
    return unpack_rows(out, grads)


def sharded_mapping_iter(local: MapperState, intr, cfg, init: bool, bins, gt_tiles,
                         mesh: Mesh, rows: tuple[int, int]):
    """One mapping iteration on this rank's share of the state
    (`mesh.shard_mapper_state`; `rows` its Adam rows, `mesh.zero_rows`):
    the unsharded iteration's steps with the collectives of the module
    docstring. -> (the share after the iteration, its MappingAux: the loss
    summed over the ranks, the visibility and overflow of its own slots,
    the raw local gradients)."""
    gmap, window = local.gmap, local.window
    r0, r1 = rows
    loss, out, grads = _forward_backward(local, intr, cfg, init, bins, gt_tiles,
                                         n_ranks=mesh.size)
    g_params, g_rho, g_theta, g_ea, g_eb, g_du, g_dv = grads
    with torch.no_grad():
        dist.all_reduce(loss, group=mesh.group)
        vis_filter, (acc, den, radii) = _densify_parts(out, g_du, g_dv, window,
                                                       gmap.active, intr)
        sums = torch.stack([acc, den])
        dist.all_reduce(sums, group=mesh.group)
        dist.all_reduce(radii, op=dist.ReduceOp.MAX, group=mesh.group)
        gmap = gmap._replace(xyz_grad_accum=gmap.xyz_grad_accum + sums[0],
                             denom=gmap.denom + sums[1],
                             max_radii2d=torch.maximum(gmap.max_radii2d, radii))
        g_rows = _sum_grad_rows(mesh, gmap.active, g_params, rows)
        p_rows = {k: v[r0:r1] for k, v in gmap.params.items()}
        new_rows, new_adam = adam_step(p_rows, g_rows, local.adam,
                                       cfg.map_lrs(local.nr_iters))
        if gmap.capacity % mesh.zero_size == 0:
            gathered = all_gather_rows(pack_rows(new_rows), mesh.zero_group)
            new_rows = unpack_rows(gathered, new_rows)
        gmap = gmap._replace(params=new_rows)
        new_window, pa_new = _pose_step(local, g_rho, g_theta, g_ea, g_eb, cfg, init)

    new_state = MapperState(gmap=gmap, adam=new_adam, window=new_window, pose_adam=pa_new,
                            nr_iters=local.nr_iters + 1, rng=local.rng)
    aux = MappingAux(loss=loss, vis_filter=vis_filter & window.valid[:, None],
                     overflow=out.overflow, overflow_parts=out.overflow_parts)
    return new_state, aux, grads
