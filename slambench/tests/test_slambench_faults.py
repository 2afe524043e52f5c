"""The correctness check catches a broken timed path: a run with the
program broken underneath comes out not correct, once for each fault a
stream cell can have (one card, so no exchange between chips is left out),
in each cell; the same run unbroken comes out correct."""

import pytest
import torch

from slambench import core
from slambench.tests import tiny_cell

CELLS = [w["name"] for w in core.load_json(core.ROOT, "BENCHMARK.json")["workloads"]]


def _state_unchanged(monkeypatch):
    """The mapping iteration's optimiser step returns its state unchanged."""
    from monogs_torch.slam import mapper

    monkeypatch.setattr(mapper, "adam_step", lambda params, grads, state, lrs: (params, state))


def _tracker_frozen(monkeypatch):
    """The tracker's optimiser step returns its state unchanged: the pose
    and the exposure never move from where the frame started."""
    from monogs_torch.slam import tracker

    monkeypatch.setattr(tracker, "_adam4_update",
                        lambda grads, st, lrs, eps: (tuple(torch.zeros_like(g) for g in grads), st))


def _half_batch(monkeypatch):
    """Half of the keyframe window left out of the mapping loss, the mean
    taken over the rest (its gradients doubled)."""
    from monogs_torch.slam import mapper

    orig = mapper._forward_backward

    def half(state, intr, cfg, init, bins, gt_tiles, *a, **k):
        valid = state.window.valid.clone()
        idx = torch.nonzero(valid).reshape(-1)
        valid[idx[len(idx) // 2:]] = False
        st = state._replace(window=state.window._replace(valid=valid))
        loss, out, (gp, *rest) = orig(st, intr, cfg, init, bins, gt_tiles, *a, **k)
        return loss, out, ({k: 2 * g for k, g in gp.items()}, *rest)

    monkeypatch.setattr(mapper, "_forward_backward", half)


def _answer_altered(monkeypatch):
    """The tracker's answer, the frame's pose, altered where it is made."""
    from monogs_torch.slam import system

    orig = system.track_frame

    def altered(*a, **k):
        res = orig(*a, **k)
        return res._replace(t=res.t + torch.tensor([0.01, 0.0, 0.0]))

    monkeypatch.setattr(system, "track_frame", altered)


FAULTS = {"state_unchanged": (_state_unchanged, "map_step_err"),
          "tracker_frozen": (_tracker_frozen, "track_step_err"),
          "half_batch": (_half_batch, "map_grad_err"),
          "answer_altered": (_answer_altered, "render_err")}


@pytest.mark.parametrize("cell", CELLS)
def test_unbroken_run_is_correct(cell):
    r = tiny_cell.run(cell)
    assert r["correct"], r["checks"]
    assert r["_info"]["map_captures"] >= 1 and r["_info"]["track_captures"] >= 3


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_broken_run_is_not_correct(fault, cell, monkeypatch):
    plant, number = FAULTS[fault]
    plant(monkeypatch)
    r = tiny_cell.run(cell)
    assert not r["correct"]
    c = r["checks"][number]
    assert c["value"] > c["limit"], (number, c)
