"""Multi-process runs (port of monogs_tpu/parallel/distributed.py).

One process per rank, each on one device: every rank runs the same SLAM
loop on the same input stream (the host logic is replicated and cheap),
and the mapper's window shards over the ranks (parallel/mesh.py,
parallel/overlap.py) with explicit collectives on `torch.distributed`:
NCCL for a run on CUDA, gloo for one on the CPU. Nothing tells a program
of a cluster, so the coordinator's address, the process count and the
rank are given (the command line's --dist-coordinator / --dist-procs /
--dist-rank).
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def backend_for(device) -> str:
    """The collective backend of a run on `device`."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def initialize_distributed(coordinator: str | None = None,
                           num_processes: int | None = None,
                           process_id: int | None = None,
                           device="cuda") -> bool:
    """Start the process group of a multi-process run, before any
    collective: `coordinator` is "host:port" (rank 0 listens there). A
    process count of 1 or less, or no coordinator and no count, is a
    single-process run and a no-op. On CUDA the rank takes the card
    `process_id % device_count`. -> True if a process group was started."""
    if num_processes is None and coordinator is None:
        return False
    if num_processes is not None and num_processes <= 1:
        return False
    if coordinator is None or num_processes is None or process_id is None:
        raise ValueError("a multi-process run needs the coordinator, the process "
                         "count and this process's rank")
    backend = backend_for(device)
    if backend == "nccl":
        torch.cuda.set_device(process_id % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                            world_size=num_processes, rank=process_id)
    return True


def rank_device(device) -> torch.device:
    """`device` as this rank uses it: a bare "cuda" becomes the rank's card
    in a multi-process run."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None and dist.is_initialized():
        return torch.device("cuda", torch.cuda.current_device())
    return device


def is_primary() -> bool:
    """True on the process that owns the artifacts (results, viewer, eval)."""
    return not dist.is_initialized() or dist.get_rank() == 0


def sync_hosts() -> None:
    """A barrier across every process (a no-op in one process)."""
    if dist.is_initialized() and dist.get_world_size() > 1:
        dist.barrier()
