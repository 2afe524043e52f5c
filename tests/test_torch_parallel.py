"""monogs_torch's window-sharded mapper over processes on the CPU (the port
of tests/test_parallel.py and tests/test_multihost.py): each rank is a
Python process of this file (`python tests/test_torch_parallel.py CASE
RANK WORLD PORT OUT`), joined by gloo over localhost, with torch at 1
thread and a time limit of its own, so that a hung collective fails the
test instead of the suite.

- one sharded iteration at 2 ranks against the unsharded `_mapping_iter`
  (tests/test_parallel.py's overlap-step checks: the loss at 1e-5, the
  summed gradients through the first Adam moments at ROADMAP Queue 3's
  gradient floor, xyz, the statistics and the window at 1e-5 / 1e-6), with
  the ZeRO rows divided and, at a capacity that does not divide, whole;
- the same on a two-level mesh, 4 ranks as 2 "hosts" of 2;
- `dryrun_multichip(2)` against JAX's single-device mapping_step sequence
  at the bounds JAX sets for its explicit path (__graft_entry__.py:142-151);
- (the sharded SLAM at 2 ranks against one rank, and the command line at
  2 ranks: tests/test_torch_parallel_slam.py, whose ranks run here too;)
- `initialize_distributed`'s no-op cases and `is_primary`;
- on a card: the sharded iteration at world size 1 on NCCL, bit for bit.
"""

import os
import sys

import numpy as np
import pytest
import torch

from monogs_torch.parallel import launch

torch.set_num_threads(2)   # the test workers share the CPUs (tests/test_torch_system.py)

RANK_TIMEOUT = 240.0
W, H = 64, 48


def _spawn(case: str, world: int, out_dir, *extra) -> list:
    """Start the ranks of one case; -> their processes."""
    port = launch.free_port()
    return launch.start_ranks(
        world, lambda r: [sys.executable, os.path.abspath(__file__), case, str(r), str(world),
                          str(port), str(out_dir), *map(str, extra)],
        env=dict(os.environ, OMP_NUM_THREADS="1", MONOGS_SYNTH_CACHE="0"))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: NCCL runs on the card only")
    return torch.device("cuda")


def _join(procs) -> list:
    """Wait for every rank, each within RANK_TIMEOUT; -> their stdouts."""
    ranks = launch.join_ranks(procs, RANK_TIMEOUT)
    for rc, _, err in ranks:
        assert rc == 0, f"rank exit {rc}:\n{err[-4000:]}"
    return [out for _, out, _ in ranks]


# -- the cases' inputs ------------------------------------------------------------------


def _intr():
    from monogs_torch.ops.graphics import Intrinsics

    return Intrinsics(fx=40.0, fy=40.0, cx=W / 2, cy=H / 2, width=W, height=H)


def iter_state(capacity: int, n_frames: int = 4, device="cpu"):
    """tests/test_parallel.py's step inputs, seeded with numpy: n_frames
    keyframes of random colour at depths 2 + 0.1 i, 0.02 i apart, and a map
    of `capacity` seeded by the init extend from keyframe 0. -> (state,
    intr, cfg)."""
    from monogs_torch.slam.camera import make_frame, window_from_list
    from monogs_torch.slam.mapper import MapperConfig, extend_event, init_mapper_state

    intr = _intr()
    cfg = MapperConfig(tile_size=16, tile_capacity=128, max_dup=8, backend="slab",
                       isotropic_loss_weight=0.1)
    frames = []
    for i in range(n_frames):
        rgb = np.random.default_rng(i).uniform(size=(H, W, 3)).astype(np.float32)
        pose = np.eye(4, dtype=np.float32)
        pose[0, 3] = 0.02 * i
        frames.append(make_frame(i, rgb, np.full((H, W), 2.0 + 0.1 * i, np.float32), pose,
                                 device=device))
    state = init_mapper_state(capacity, 1, window_from_list(frames, n_frames), seed=0)
    state, _ = extend_event(state, frames[0], 0, intr, cfg, init=True)
    return state, intr, cfg


def _one_iteration(state, intr, cfg, mesh=None):
    """One mapping iteration (non-init), sharded over `mesh` when given, as
    mapping_span runs it. -> (the whole state after it, its aux)."""
    from monogs_torch.slam import mapper as tm

    return tm.mapping_span(state, intr, cfg, False, 0, 1, mesh=mesh)


def _check_iteration(got, want):
    """tests/test_parallel.py's overlap-step checks, with the gradients'
    floor of ROADMAP Queue 3 (1e-4 of the channel's scale beside rtol 2e-3
    / atol 1e-6) on the first moments, 0.1 x the summed masked gradient."""
    (s2, a2), (s1, a1) = got, want
    np.testing.assert_allclose(float(a2.loss), float(a1.loss), rtol=1e-5)
    for k, m1 in s1.adam.mu.items():
        m1 = m1.numpy().reshape(m1.shape[0], -1)
        m2 = s2.adam.mu[k].numpy().reshape(m1.shape)
        bound = 2e-3 * np.abs(m1) + 1e-6 + 1e-4 * np.abs(m1).max(0)
        assert (np.abs(m2 - m1) <= bound).all(), (k, float(np.abs(m2 - m1).max()))
    np.testing.assert_allclose(s2.gmap.params["xyz"], s1.gmap.params["xyz"], atol=1e-5)
    np.testing.assert_allclose(s2.gmap.xyz_grad_accum, s1.gmap.xyz_grad_accum, atol=1e-5)
    np.testing.assert_allclose(s2.gmap.denom, s1.gmap.denom, atol=0)
    np.testing.assert_allclose(s2.gmap.max_radii2d, s1.gmap.max_radii2d, atol=1e-6)
    for f in ("R", "t", "exposure_a", "exposure_b"):
        np.testing.assert_allclose(getattr(s2.window.frames, f), getattr(s1.window.frames, f),
                                   atol=1e-6, err_msg=f)
    for a, b in zip(s2.pose_adam, s1.pose_adam):
        np.testing.assert_allclose(a, b, atol=1e-6)
    assert torch.equal(a2.vis_filter, a1.vis_filter)
    assert int(a2.overflow) == int(a1.overflow)
    assert s2.adam.mu["xyz"].shape == s1.adam.mu["xyz"].shape   # gathered whole


# -- the ranks' side ------------------------------------------------------------------


def _rank_iteration(mesh, out_dir, capacity: str):
    from monogs_torch.parallel.mesh import shard_mapper_state, zero_rows

    state, intr, cfg = iter_state(int(capacity))
    rows = zero_rows(mesh, state.gmap.capacity)
    local = shard_mapper_state(state, mesh)
    assert local.window.capacity == state.window.capacity // mesh.size
    assert local.adam.mu["xyz"].shape[0] == rows[1] - rows[0]
    _check_iteration(_one_iteration(state, intr, cfg, mesh),
                     _one_iteration(state, intr, cfg))
    print("rows", *rows)


def _rank_slam(mesh_devices: int, out_dir, async_mode: str):
    from test_torch_parallel_slam import build_slam

    slam = build_slam(mesh_devices)
    ate = slam.run_async() if async_mode == "1" else slam.run()
    st = slam.state.gmap
    torch.save({"ate": ate, "active": st.active, "params": st.params,
                "poses": slam.est_poses},
               os.path.join(out_dir, f"slam{mesh_devices}_{slam.mesh.rank}.pt"))


def _rank_main(case, rank, world, port, out_dir, *extra):
    torch.set_num_threads(1)
    from monogs_torch.parallel.distributed import initialize_distributed
    from monogs_torch.parallel.mesh import make_mesh, make_mesh_2level

    rank, world = int(rank), int(world)
    initialize_distributed(f"127.0.0.1:{port}", world, rank, device="cpu")
    if case == "iteration":
        _rank_iteration(make_mesh(world, "cpu"), out_dir, *extra)
    elif case == "two_level":
        _rank_iteration(make_mesh_2level(2), out_dir, *extra)
    elif case == "slam":
        _rank_slam(world, out_dir, *extra)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    _rank_main(*sys.argv[1:])
    sys.exit(0)


# -- the tests ----------------------------------------------------------------------


@pytest.mark.parametrize("capacity", [512, 511])
def test_sharded_iteration_matches_unsharded(tmp_path, capacity):
    """2 ranks; 512 rows divide (ZeRO rows of 256), 511 do not (whole
    moments, an all-reduce)."""
    outs = _join(_spawn("iteration", 2, tmp_path, capacity))
    rows = [tuple(int(x) for x in o.split()[1:3]) for o in outs]
    if capacity == 512:
        assert rows == [(0, 256), (256, 512)]
    else:
        assert rows == [(0, 511), (0, 511)]


def test_two_level_mesh(tmp_path):
    """4 ranks as 2 hosts of 2: the window over all 4, the ZeRO rows over a
    host's 2 (each host's ranks hold rows 0-255 and 256-511)."""
    outs = _join(_spawn("two_level", 4, tmp_path, 512))
    rows = [tuple(int(x) for x in o.split()[1:3]) for o in outs]
    assert rows == [(0, 256), (256, 512), (0, 256), (256, 512)]


def test_initialize_distributed_noop_and_primary():
    import torch.distributed as dist

    from monogs_torch.parallel.distributed import (
        initialize_distributed,
        is_primary,
        sync_hosts,
    )

    assert not dist.is_initialized()
    assert initialize_distributed() is False
    assert initialize_distributed("127.0.0.1:1", 1, 0, device="cpu") is False
    assert initialize_distributed(None, 0, None, device="cpu") is False
    with pytest.raises(ValueError):
        initialize_distributed("127.0.0.1:1", 2, None, device="cpu")
    assert not dist.is_initialized()
    assert is_primary()
    sync_hosts()                               # a no-op in one process


def test_mesh_devices_without_a_group_raises():
    import torch.distributed as dist

    from monogs_torch.parallel.mesh import make_mesh

    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="needs a process group of 2"):
        make_mesh(2, "cpu")
    assert not dist.is_initialized()


def test_dryrun_multichip_matches_jax(tmp_path, monkeypatch):
    """The port's dryrun at 2 ranks (3 steps, densify, visibility, prune, 1
    step; each rank a process) against JAX's mapping_step sequence on one
    device from the same state and draws: losses 3e-3 relative, xyz 2e-2,
    equal active counts (the bounds JAX sets its explicit path,
    __graft_entry__.py:142-151). The tighter SPMD bounds (:156-168: 1e-3,
    5e-3) are reported."""
    import jax
    import jax.numpy as jnp

    from monogs_torch.parallel import dryrun
    from monogs_tpu.models import gaussian_map as jgm
    from monogs_tpu.models.optim import init_adam
    from monogs_tpu.ops.graphics import Intrinsics
    from monogs_tpu.slam import mapper as jm
    from monogs_tpu.slam.camera import make_frame, window_from_list

    monkeypatch.setenv("OMP_NUM_THREADS", "1")    # each rank's torch threads
    inputs = dryrun.dryrun_inputs(2)
    # JAX's densify draws its split noise from the state's key
    # (tests/test_torch_system.py's _feed_draws): the port takes the same.
    inputs["split_noise"] = np.array(jax.random.normal(
        jax.random.split(jax.random.PRNGKey(0))[1], inputs["split_noise"].shape))
    res = dryrun.dryrun_multichip(2, device="cpu", inputs=inputs, timeout=RANK_TIMEOUT)

    intr = Intrinsics(**dryrun.INTR)
    cfg = jm.MapperConfig(backend="pallas", **dryrun.CFG)
    frames = [make_frame(i, inputs["rgb"][i], inputs["depth"][i], inputs["pose"][i])
              for i in range(2)]
    C = inputs["active"].shape[0]
    gmap = jgm.init_map(C, 1)
    gmap = gmap._replace(params={k: jnp.asarray(v) for k, v in inputs["params"].items()},
                         active=jnp.asarray(inputs["active"]))
    state = jm.MapperState(gmap=gmap, adam=init_adam(gmap.params),
                           window=window_from_list(frames, 2), pose_adam=jm.init_pose_adam(2),
                           nr_iters=jnp.zeros((), jnp.int32), rng=jax.random.PRNGKey(0))
    losses = []
    for _ in range(3):
        state, aux = jm.mapping_step(state, intr, cfg, init=False)
        losses.append(float(aux.loss))
    state, _ = jm.densify_event(state, cfg, init_phase=False)
    vis = jm.visibility_pass(state, intr, cfg)
    state, _ = jm.covisibility_prune(state, vis, jnp.zeros((), jnp.int32), cfg)
    state, aux = jm.mapping_step(state, intr, cfg, init=False)
    losses.append(float(aux.loss))

    sharded = res["sharded"]
    for k, (a, b) in enumerate(zip(losses, sharded["losses"])):
        assert abs(a - b) <= 3e-3 * max(1.0, abs(a)), (k, a, b)
    xyz_err = float(np.abs(np.asarray(state.gmap.params["xyz"]) - sharded["xyz"]).max())
    assert xyz_err <= 2e-2
    assert int(state.gmap.num_active) == sharded["active"] > 0
    loss_err = max(abs(a - b) / max(1.0, abs(a)) for a, b in zip(losses, sharded["losses"]))
    print(f"dryrun(2) vs JAX: loss rel {loss_err:.3e} (SPMD bound 1e-3: "
          f"{loss_err <= 1e-3}), xyz {xyz_err:.3e} (SPMD bound 5e-3: {xyz_err <= 5e-3})")


@pytest.mark.gpu
def test_sharded_iteration_world1_nccl_is_bitwise(cuda_device):
    """World size 1 on NCCL: the sharded iteration's reduce-scatter and
    all-gather are copies, so it is `_mapping_iter` bit for bit."""
    import torch.distributed as dist

    from monogs_torch.parallel.mesh import make_mesh

    mesh = make_mesh(1, "cuda")
    try:
        state, intr, cfg = iter_state(512, device="cuda")
        s2, a2 = _one_iteration(state, intr, cfg, mesh)
        s1, a1 = _one_iteration(state, intr, cfg)
        assert torch.equal(a2.loss, a1.loss)
        for k in s1.gmap.params:
            assert torch.equal(s2.gmap.params[k], s1.gmap.params[k]), k
            assert torch.equal(s2.adam.mu[k], s1.adam.mu[k]), k
        assert torch.equal(s2.window.frames.R, s1.window.frames.R)
        assert torch.equal(s2.gmap.xyz_grad_accum, s1.gmap.xyz_grad_accum)
    finally:
        dist.destroy_process_group()
