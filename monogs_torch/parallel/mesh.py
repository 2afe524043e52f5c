"""The window mesh: which ranks share the keyframe window and the Adam rows
(port of monogs_tpu/parallel/mesh.py).

The JAX package annotates the window's leading axis as sharded over a
device mesh and lets XLA's SPMD partitioner insert the collectives. Eager
PyTorch has no partitioner, so here a mesh is a set of process groups and
the state is placed by hand:

- every rank holds the whole state between mapping spans: the map, the
  window's frames (every rank reads the same stream; the window is a few
  frames), the pose Adam and the Gaussian Adam moments, bit-identical on
  every rank;
- for a span, `shard_mapper_state` takes the rank's share: its window
  slots (host-major), their pose-Adam rows and its rows of the Adam
  moments (ZeRO: the capacity divided over the ZeRO group; the moments
  stay whole where the capacity does not divide, as in the JAX package);
- at the span's end `unshard_mapper_state` gathers the slots' poses,
  exposures and pose moments, the Adam rows and the last iteration's
  visibility back into the whole state.

A two-level mesh (`make_mesh_2level`) groups the ranks by host: the window
shards over every rank, the ZeRO rows over a host's ranks only, so the
reduce-scatter and all-gather around the sharded Adam stay on the host and
only the gradient rows' sum crosses hosts.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from ..models.optim import AdamState
from ..slam.camera import Frame, Window
from .distributed import backend_for


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A window mesh: `group` holds every rank (the window and the sums of
    the loss and the densification statistics), `zero_group` the ranks that
    divide the Adam rows between them, `cross_group` (two-level meshes
    only) the ranks on other hosts that hold the same rows."""

    group: object
    rank: int
    size: int
    zero_group: object
    zero_rank: int
    zero_size: int
    cross_group: object = None


def make_mesh(n_devices: int | None = None, device="cuda") -> Mesh:
    """The flat mesh over every rank of the process group, which must have
    n_devices ranks. With no process group, n_devices 1 (or None) starts a
    local one of one rank (a one-device mesh, as JAX's `mesh_devices: 1`);
    more raises: a run never goes unsharded without saying so."""
    if not dist.is_initialized():
        if n_devices not in (None, 1):
            raise RuntimeError(
                f"mesh_devices {n_devices} needs a process group of {n_devices} ranks "
                f"(--dist-coordinator / --dist-procs / --dist-rank); none is initialized")
        dist.init_process_group(backend_for(device), store=dist.HashStore(),
                                world_size=1, rank=0)
    world = dist.get_world_size()
    if n_devices is not None and n_devices != world:
        raise RuntimeError(f"mesh_devices {n_devices} on a process group of {world} ranks")
    rank = dist.get_rank()
    group = dist.group.WORLD
    return Mesh(group=group, rank=rank, size=world, zero_group=group, zero_rank=rank,
                zero_size=world)


def make_mesh_2level(local_size: int) -> Mesh:
    """The (host, local) mesh: ranks h * local_size ... (h + 1) * local_size
    - 1 are host h's. Every rank calls it (it creates the groups)."""
    world, rank = dist.get_world_size(), dist.get_rank()
    if world % local_size:
        raise ValueError(f"{world} ranks do not form hosts of {local_size}")
    hosts = world // local_size
    zero = cross = None
    for h in range(hosts):
        g = dist.new_group([h * local_size + i for i in range(local_size)])
        if rank // local_size == h:
            zero = g
    for i in range(local_size):
        g = dist.new_group([h * local_size + i for h in range(hosts)])
        if rank % local_size == i:
            cross = g
    return Mesh(group=dist.group.WORLD, rank=rank, size=world, zero_group=zero,
                zero_rank=rank % local_size, zero_size=local_size, cross_group=cross)


def window_slots(mesh: Mesh, capacity: int) -> tuple[int, int]:
    """This rank's window slots [s0, s1) (host-major: a host's slots are
    contiguous); the capacity must divide over the mesh."""
    if capacity % mesh.size:
        raise ValueError(f"window capacity {capacity} does not divide over {mesh.size} ranks")
    n = capacity // mesh.size
    return mesh.rank * n, (mesh.rank + 1) * n


def zero_rows(mesh: Mesh, capacity: int) -> tuple[int, int]:
    """This rank's Adam rows [r0, r1) of a map of `capacity`: its share of
    the ZeRO group, or every row when the capacity does not divide."""
    if capacity % mesh.zero_size:
        return 0, capacity
    n = capacity // mesh.zero_size
    return mesh.zero_rank * n, (mesh.zero_rank + 1) * n


def all_gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    """The ranks' `x` stacked along dim 0, in rank order."""
    x = x.contiguous()
    out = x.new_empty((dist.get_world_size(group) * x.shape[0],) + x.shape[1:])
    dist.all_gather_into_tensor(out, x, group=group)
    return out


def pack_rows(leaves: dict) -> torch.Tensor:
    """The leaves side by side, one row per Gaussian: (C, sum of widths)."""
    return torch.cat([v.reshape(v.shape[0], -1) for v in leaves.values()], 1)


def unpack_rows(packed: torch.Tensor, like: dict) -> dict:
    """`pack_rows`'s inverse on `packed`'s rows, the leaves shaped as `like`'s."""
    widths = [v[0].numel() for v in like.values()]
    return {k: p.reshape((packed.shape[0],) + v.shape[1:]).contiguous()
            for (k, v), p in zip(like.items(), packed.split(widths, 1))}


def shard_mapper_state(state, mesh: Mesh):
    """This rank's share of a MapperState (see the module docstring): its
    window slots and their pose-Adam rows, the whole map, its rows of the
    Gaussian Adam moments. Views, not copies."""
    s0, s1 = window_slots(mesh, state.window.capacity)
    window = Window(frames=Frame(*(x[s0:s1] for x in state.window.frames)),
                    valid=state.window.valid[s0:s1])
    pa = state.pose_adam
    pose_adam = type(pa)(*(x[s0:s1] for x in pa[:-1]), pa.step)
    r0, r1 = zero_rows(mesh, state.gmap.capacity)
    adam = AdamState(mu={k: v[r0:r1] for k, v in state.adam.mu.items()},
                     nu={k: v[r0:r1] for k, v in state.adam.nu.items()},
                     step=state.adam.step)
    return state._replace(window=window, pose_adam=pose_adam, adam=adam)


def unshard_mapper_state(local, aux, mesh: Mesh, like):
    """The whole state and aux after a span from this rank's share `local`
    (`like`: the state the share was taken from, for the window's fields
    no iteration writes): the window slots' poses, exposures and pose
    moments and the Adam rows gathered, the visibility gathered, the
    overflow summed. Every rank ends with the same state."""
    f, Wl = local.window.frames, local.window.capacity
    pa = local.pose_adam
    per_slot = torch.cat([f.R.reshape(Wl, 9), f.t, f.exposure_a[:, None],
                          f.exposure_b[:, None]] + [x.reshape(Wl, -1) for x in pa[:-1]], 1)
    per_slot = all_gather_rows(per_slot, mesh.group)
    Wc = per_slot.shape[0]
    R, t, ea, eb, rest = per_slot.split([9, 3, 1, 1, per_slot.shape[1] - 14], 1)
    frames = like.window.frames._replace(R=R.reshape(Wc, 3, 3).contiguous(),
                                         t=t.contiguous(), exposure_a=ea[:, 0].contiguous(),
                                         exposure_b=eb[:, 0].contiguous())
    widths = [x[0].numel() for x in pa[:-1]]
    moments = [x.reshape((Wc,) + y.shape[1:]).contiguous()
               for x, y in zip(rest.split(widths, 1), pa[:-1])]
    adam = local.adam
    if next(iter(adam.mu.values())).shape[0] < local.gmap.capacity:
        rows = {**{("mu", k): v for k, v in adam.mu.items()},
                **{("nu", k): v for k, v in adam.nu.items()}}
        full = unpack_rows(all_gather_rows(pack_rows(rows), mesh.zero_group), rows)
        adam = AdamState(mu={k: full["mu", k] for k in adam.mu},
                         nu={k: full["nu", k] for k in adam.nu}, step=adam.step)
    vis = all_gather_rows(aux.vis_filter.to(torch.uint8), mesh.group).bool()
    ov = torch.cat([aux.overflow[None], aux.overflow_parts]).to(torch.int32)
    dist.all_reduce(ov, group=mesh.group)
    state = local._replace(window=Window(frames=frames, valid=like.window.valid),
                           pose_adam=type(pa)(*moments, pa.step), adam=adam)
    return state, aux._replace(vis_filter=vis, overflow=ov[0], overflow_parts=ov[1:])
