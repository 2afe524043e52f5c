"""The multi-rank dry run (twin of __graft_entry__.py::dryrun_multichip).

    python -c "from monogs_torch.parallel.dryrun import dryrun_multichip; dryrun_multichip(2, 'cpu')"

The event sequence a real run meets between keyframes, on tiny shapes
(64x48, one keyframe per rank): 3 mapping steps, a densify event, a
visibility pass and a covisibility prune, and one step after the map's
topology changed. It runs once sharded over n ranks (n processes of this
module, joined on localhost: gloo on the CPU, NCCL on rank r's card r) and
once unsharded in the calling process, from the same numpy-seeded state
and split draws, and holds the two to the bounds the JAX package sets its
explicit path: losses 3e-3 relative, xyz 2e-2, equal active counts (Adam's
eps of 1e-15 turns a rounding in a near-zero gradient into a full step,
which the sequence compounds).

The JAX dry run seeds its map with an init extend, whose draws come from
a JAX key; here the map is drawn with numpy, so that the JAX package can
start from the very same state (tests/test_torch_parallel.py).
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile

import numpy as np
import torch

from .launch import free_port, join_ranks, start_ranks

INTR = dict(fx=40.0, fy=40.0, cx=32.0, cy=24.0, width=64, height=48)
# __graft_entry__.py's MapperConfig: gaussian_th lowered from 0.7, since
# after 3 steps the opacities are near their seed and the densify event
# would prune the whole map. prune_coviz 0 (not 3): with a keyframe a rank
# the window may hold 2, and the prune would take every Gaussian; at 0 it
# takes the ones no keyframe sees.
CFG = dict(tile_capacity=128, max_dup=8, gaussian_th=0.05, prune_coviz=0)
LOSS_RTOL, XYZ_ATOL = 3e-3, 2e-2


def dryrun_inputs(n: int, capacity: int = 1024, n_live: int = 600, seed: int = 0) -> dict:
    """The sequence's inputs, numpy: n keyframes (random colour, depth
    2 + 0.05 i, 0.02 i apart in x), a map of `capacity` rows with n_live
    Gaussians, a tenth of them outside every view (the prune's), and the
    densify event's split draws (2, capacity, 3)."""
    rng = np.random.default_rng(seed)
    H, W = INTR["height"], INTR["width"]
    pose = np.repeat(np.eye(4, dtype=np.float32)[None], n, 0)
    pose[:, 0, 3] = 0.02 * np.arange(n)
    z = rng.uniform(1.8, 2.3, n_live)
    u = rng.uniform(0, W, n_live)
    u[: n_live // 10] += 2 * W
    x = (u - INTR["cx"]) / INTR["fx"] * z
    y = (rng.uniform(0, H, n_live) - INTR["cy"]) / INTR["fy"] * z
    live = {
        "xyz": np.stack([x, y, z], 1),
        "rgb": rng.uniform(0.1, 0.9, (n_live, 3)),
        "log_scales": np.log(rng.uniform(0.01, 0.04, (n_live, 3))),
        "quats": np.array([1.0, 0, 0, 0]) + 0.1 * rng.normal(size=(n_live, 4)),
        "opacity_logit": rng.normal(0.0, 0.5, n_live),
    }
    params = {}
    for k, v in live.items():
        full = np.zeros((capacity,) + v.shape[1:], np.float32)
        if k == "quats":
            full[:, 0] = 1.0
        full[:n_live] = v
        params[k] = full
    return {"rgb": (rng.uniform(size=(n, H, W, 3)) * 0.5 + 0.25).astype(np.float32),
            "depth": (2.0 + 0.05 * np.arange(n, dtype=np.float32))[:, None, None]
            * np.ones((n, H, W), np.float32),
            "pose": pose, "params": params, "active": np.arange(capacity) < n_live,
            "split_noise": rng.normal(size=(2, capacity, 3)).astype(np.float32)}


def _state(inputs: dict, device):
    from ..models.optim import init_adam
    from ..slam.camera import make_frame, window_from_list
    from ..slam.mapper import init_mapper_state

    n = inputs["rgb"].shape[0]
    frames = [make_frame(i, inputs["rgb"][i], inputs["depth"][i], inputs["pose"][i],
                         device=device) for i in range(n)]
    state = init_mapper_state(inputs["active"].shape[0], 1, window_from_list(frames, n))
    params = {k: torch.as_tensor(v, device=device) for k, v in inputs["params"].items()}
    gmap = state.gmap._replace(params=params,
                               active=torch.as_tensor(inputs["active"], device=device))
    return state._replace(gmap=gmap, adam=init_adam(params))


def _sequence(inputs: dict, device, mesh=None) -> dict:
    """The event sequence from the inputs' state (sharded over `mesh`
    when given). -> losses, final xyz and active count."""
    from ..ops.graphics import Intrinsics
    from ..slam import mapper as tm

    intr, cfg = Intrinsics(**INTR), tm.MapperConfig(**CFG)
    state = _state(inputs, device)
    losses = []
    for _ in range(3):
        state, aux = tm.mapping_span(state, intr, cfg, False, 0, 1, mesh=mesh)
        losses.append(float(aux.loss))
    noise = torch.as_tensor(inputs["split_noise"], device=device)
    state, _ = tm.densify_event(state, cfg, init_phase=False, split_noise=noise)
    vis = tm.visibility_pass(state, intr, cfg)
    state, pruned = tm.covisibility_prune(state, vis, 0, cfg)
    state, aux = tm.mapping_span(state, intr, cfg, False, 0, 1, mesh=mesh)
    losses.append(float(aux.loss))
    return {"losses": losses, "xyz": state.gmap.params["xyz"].cpu().numpy(),
            "active": int(state.gmap.num_active), "pruned": int(pruned.sum())}


def _save(path: str, inputs: dict):
    flat = {k: v for k, v in inputs.items() if k != "params"}
    flat.update({f"param_{k}": v for k, v in inputs["params"].items()})
    np.savez(path, **flat)


def _load(path: str) -> dict:
    with np.load(path) as z:
        out = {k: z[k] for k in z.files if not k.startswith("param_")}
        out["params"] = {k[6:]: z[k] for k in z.files if k.startswith("param_")}
    return out


def dryrun_multichip(n: int, device="cuda", inputs: dict | None = None,
                     timeout: float = 600.0) -> dict:
    """The sequence sharded over n ranks (n processes, each within
    `timeout` s) against the unsharded one in this process, from
    `inputs` (default `dryrun_inputs(n)`). Raises on a rank that fails or
    a result off the bounds. -> {"single": ..., "sharded": ..., errors}."""
    inputs = dryrun_inputs(n) if inputs is None else inputs
    with tempfile.TemporaryDirectory(prefix="monogs_dryrun_") as tmp:
        _save(os.path.join(tmp, "inputs.npz"), inputs)
        port = free_port()
        procs = start_ranks(n, lambda r: [
            sys.executable, "-m", "monogs_torch.parallel.dryrun", "--rank", str(r),
            "--world", str(n), "--port", str(port), "--device", str(device), "--dir", tmp])
        try:
            single = _sequence(inputs, torch.device(device))
        finally:
            ranks = join_ranks(procs, timeout)
        for r, (rc, _, err) in enumerate(ranks):
            if rc != 0:
                raise RuntimeError(f"dryrun rank {r} exited {rc}:\n{err[-4000:]}")
        with np.load(os.path.join(tmp, "result.npz")) as z:
            sharded = {"losses": z["losses"].tolist(), "xyz": z["xyz"],
                       "active": int(z["active"]), "pruned": int(z["pruned"])}
    loss_err = max(abs(a - b) / max(1.0, abs(a))
                   for a, b in zip(single["losses"], sharded["losses"]))
    xyz_err = float(np.abs(single["xyz"] - sharded["xyz"]).max())
    if not (loss_err <= LOSS_RTOL and xyz_err <= XYZ_ATOL
            and single["active"] == sharded["active"] > 0
            and single["pruned"] == sharded["pruned"] > 0):
        raise AssertionError(
            f"dryrun_multichip({n}): sharded against unsharded: loss {loss_err:.3e} "
            f"(bound {LOSS_RTOL}), xyz {xyz_err:.3e} (bound {XYZ_ATOL}), active "
            f"{sharded['active']} / {single['active']}, pruned {sharded['pruned']} / "
            f"{single['pruned']}")
    print(f"dryrun_multichip({n}): OK, 3 steps + densify + coviz prune + 1 step, "
          f"loss={sharded['losses'][-1]:.4f}, active={sharded['active']}, "
          f"pruned={sharded['pruned']}, "
          f"max loss rel err {loss_err:.3e}, max xyz err {xyz_err:.3e}")
    return {"single": single, "sharded": sharded, "loss_rel_err": loss_err,
            "xyz_err": xyz_err}


def _rank_main(argv=None):
    ap = argparse.ArgumentParser(description="one rank of dryrun_multichip")
    for name in ("--rank", "--world", "--port"):
        ap.add_argument(name, type=int, required=True)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dir", required=True)
    args = ap.parse_args(argv)
    from .distributed import initialize_distributed, rank_device
    from .mesh import make_mesh

    initialize_distributed(f"127.0.0.1:{args.port}", args.world, args.rank, args.device)
    device = rank_device(args.device)
    mesh = make_mesh(args.world, device)
    res = _sequence(_load(os.path.join(args.dir, "inputs.npz")), device, mesh)
    if args.rank == 0:
        np.savez(os.path.join(args.dir, "result.npz"), losses=np.array(res["losses"]),
                 xyz=res["xyz"], active=res["active"], pruned=res["pruned"])
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    _rank_main()
