"""One step of Adam (Kingma and Ba 2015): on the map's parameters, as
MonoGS's Gaussian optimiser runs it (per-leaf learning rates, the position
rate on 3D Gaussian splatting's exponential schedule, beta 0.9 / 0.999,
eps 1e-15, and the gradients of inactive rows set to zero), and the step
itself (`adam_delta`), as the tracker's optimiser of the pose and
exposure takes it."""

from __future__ import annotations

import math

import torch


def position_lr(step: int, lr_init: float, lr_final: float, max_steps: int) -> float:
    t = min(max(step / max_steps, 0.0), 1.0)
    return math.exp(math.log(lr_init) * (1 - t) + math.log(lr_final) * t)


def adam_delta(g, m, v, step: int, lr: float, b1=0.9, b2=0.999, eps=1e-15):
    """The change Adam makes from the moments (m, v) after `step` steps."""
    t = step + 1
    m = b1 * m + (1 - b1) * g
    v = b2 * v + (1 - b2) * g * g
    return -lr * (m / (1 - b1 ** t)) / (torch.sqrt(v / (1 - b2 ** t)) + eps)


def adam_step(params: dict, grads: dict, mu: dict, nu: dict, step: int, lrs: dict,
              active: torch.Tensor, b1=0.9, b2=0.999, eps=1e-15) -> dict:
    """-> the parameters after the step (step counts the steps before it)."""
    out = {}
    for k, p in params.items():
        g = torch.where(active.reshape(-1, *([1] * (p.dim() - 1))), grads[k], torch.zeros_like(p))
        out[k] = p + adam_delta(g, mu[k], nu[k], step, lrs[k], b1, b2, eps)
    return out
