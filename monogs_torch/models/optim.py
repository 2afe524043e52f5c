"""Masked per-leaf Adam for the Gaussian map (port of
monogs_tpu/models/optim.py).

The moments live in dictionaries shaped like the parameter dictionary, so
densify and prune zero the moments of new or replaced rows with one masked
write per leaf (`mask_rows`) instead of optimiser-state surgery. Every
function returns new tensors and leaves its inputs as they were, as the
JAX package's pure functions do.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

ADAM_EPS = 1e-15  # the reference's per-group Adam eps


class AdamState(NamedTuple):
    mu: dict             # first moments, same keys and shapes as params
    nu: dict             # second moments
    step: torch.Tensor   # () int32 shared step count


def init_adam(params: dict) -> AdamState:
    dev = next(iter(params.values())).device
    return AdamState(mu={k: torch.zeros_like(v) for k, v in params.items()},
                     nu={k: torch.zeros_like(v) for k, v in params.items()},
                     step=torch.zeros((), dtype=torch.int32, device=dev))


def adam_step(params: dict, grads: dict, state: AdamState, lrs: dict,
              b1: float = 0.9, b2: float = 0.999, eps: float = ADAM_EPS):
    """One Adam step with per-leaf learning rates (floats or () tensors);
    -> (new params, new AdamState)."""
    step = state.step + 1
    t = step.to(torch.float32)
    bc1 = 1.0 - b1 ** t
    bc2 = 1.0 - b2 ** t
    mu = {k: b1 * state.mu[k] + (1 - b1) * grads[k] for k in params}
    nu = {k: b2 * state.nu[k] + (1 - b2) * grads[k] * grads[k] for k in params}
    new = {k: params[k] - lrs[k] * (mu[k] / bc1) / (torch.sqrt(nu[k] / bc2) + eps)
           for k in params}
    return new, AdamState(mu=mu, nu=nu, step=step)


def _rows(mask: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return mask.reshape(mask.shape + (1,) * (x.dim() - mask.dim()))


def mask_rows(state: AdamState, row_mask: torch.Tensor) -> AdamState:
    """Zero the moments of the rows where row_mask is True."""
    def z(x):
        return torch.where(_rows(row_mask, x), torch.zeros_like(x), x)
    return AdamState(mu={k: z(v) for k, v in state.mu.items()},
                     nu={k: z(v) for k, v in state.nu.items()}, step=state.step)


def zero_leaf(state: AdamState, leaf_name: str) -> AdamState:
    """Zero the moments of one parameter leaf (the opacity resets)."""
    mu, nu = dict(state.mu), dict(state.nu)
    mu[leaf_name] = torch.zeros_like(mu[leaf_name])
    nu[leaf_name] = torch.zeros_like(nu[leaf_name])
    return AdamState(mu=mu, nu=nu, step=state.step)


def expon_lr(step, lr_init: float, lr_final: float, lr_delay_steps: float,
             lr_delay_mult: float, max_steps: float):
    """Exponential learning-rate schedule; `step` may be a device tensor,
    and the result then is one (no host read)."""
    step = torch.as_tensor(step, dtype=torch.float32)
    t = torch.clamp(step / max_steps, 0.0, 1.0)
    # float32 logs of the rates, as the JAX package takes them
    log_i, log_f = torch.log(torch.tensor([lr_init, lr_final])).tolist()
    log_lerp = torch.exp(log_i * (1 - t) + log_f * t)
    if lr_delay_steps > 0:
        delay_rate = lr_delay_mult + (1 - lr_delay_mult) * torch.sin(
            0.5 * math.pi * torch.clamp(step / lr_delay_steps, 0, 1))
    else:
        delay_rate = 1.0
    return delay_rate * log_lerp
