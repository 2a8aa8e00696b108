"""The optax pieces the trainers use: global norm, clip by global norm, Adam
(the learner) and AdamW (the offline trainer).

Written out rather than taken from `torch.optim`, because the update must
step as optax does:
  * one step count for all leaves, and every leaf stepped, a leaf whose
    gradient is zero included (`torch.optim.Adam` skips a parameter whose
    `.grad` is None, and keeps a count per parameter, so its bias correction
    would drift from optax's once a stage starts training another head);
  * `clip_by_global_norm`: g if |g| < max else (g / |g|) * max
    (`torch.nn.utils.clip_grad_norm_` divides by |g| + 1e-6);
  * Adam as `optax.scale_by_adam` then `scale(-lr)`: mu_hat = mu / (1 - b1^t),
    nu_hat = nu / (1 - b2^t), u = mu_hat / (sqrt(nu_hat) + eps), p += -lr * u,
    with the bias corrections computed in f32 as optax does.
  * AdamW as `optax.adamw(lr)`: `scale_by_adam` -> `add_decayed_weights`
    (weight decay 1e-4, no mask) -> `scale(-lr)`, so
    u = mu_hat / (sqrt(nu_hat) + eps) + 1e-4 * p, p += -lr * u. Every leaf is
    stepped, a leaf whose gradient is None too (it gets a zero gradient): in
    behaviour cloning with one tower the critic head gets no gradient from
    the loss, yet optax still decays it and counts the step for it.
The moments are updated in place; the step count is a host int (no device
read is needed to step).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch


def global_norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every element of every tensor (0-d f32)."""
    return torch.sqrt(sum((t.float() * t.float()).sum() for t in tensors))


def clip_by_global_norm(
    grads: Sequence[torch.Tensor], max_norm: float
) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """optax.clip_by_global_norm -> (clipped grads, the global norm before the
    clip), without a host synchronisation: the select between g and
    (g / |g|) * max runs on the device."""
    norm = global_norm(grads)
    keep = norm < max_norm
    div = torch.where(keep, torch.ones_like(norm), norm)
    mul = torch.where(keep, torch.ones_like(norm), torch.full_like(norm, max_norm))
    return [g / div * mul for g in grads], norm


@dataclass
class AdamState:
    count: int  # steps taken (optax's single count for every leaf)
    mu: List[torch.Tensor]
    nu: List[torch.Tensor]


def adam_init(params: Sequence[torch.Tensor]) -> AdamState:
    return AdamState(
        count=0,
        mu=[torch.zeros_like(p, dtype=torch.float32) for p in params],
        nu=[torch.zeros_like(p, dtype=torch.float32) for p in params],
    )


@torch.no_grad()
def adam_step(
    params: Sequence[torch.Tensor], grads: Sequence[torch.Tensor], state: AdamState,
    lr: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
) -> AdamState:
    """One optax.adam(lr) step, applied to `params` in place; returns the new
    state (moments updated in place, count + 1)."""
    count = state.count + 1
    bc1 = float(1 - np.float32(b1) ** np.float32(count))
    bc2 = float(1 - np.float32(b2) ** np.float32(count))
    for p, g, mu, nu in zip(params, grads, state.mu, state.nu):
        mu.mul_(b1).add_(g, alpha=1 - b1)
        nu.mul_(b2).add_(g * g, alpha=1 - b2)
        u = (mu / bc1) / (torch.sqrt(nu / bc2) + eps)
        p.add_(u * -lr)
    return AdamState(count=count, mu=state.mu, nu=state.nu)


ADAMW_WEIGHT_DECAY = 1e-4  # optax.adamw's default


def adamw_init(params: Sequence[torch.Tensor]) -> AdamState:
    """AdamW keeps Adam's state: one count, the two moments."""
    return adam_init(params)


@torch.no_grad()
def adamw_step(
    params: Sequence[torch.Tensor], grads: Sequence[Optional[torch.Tensor]], state: AdamState,
    lr: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
    weight_decay: float = ADAMW_WEIGHT_DECAY,
) -> AdamState:
    """One optax.adamw(lr) step, applied to `params` in place; a None
    gradient counts as zeros. Returns the new state (moments updated in
    place, count + 1)."""
    count = state.count + 1
    bc1 = float(1 - np.float32(b1) ** np.float32(count))
    bc2 = float(1 - np.float32(b2) ** np.float32(count))
    for p, g, mu, nu in zip(params, grads, state.mu, state.nu):
        if g is None:
            g = torch.zeros_like(mu)
        mu.mul_(b1).add_(g, alpha=1 - b1)
        nu.mul_(b2).add_(g * g, alpha=1 - b2)
        u = (mu / bc1) / (torch.sqrt(nu / bc2) + eps) + weight_decay * p
        p.add_(u * -lr)
    return AdamState(count=count, mu=state.mu, nu=state.nu)
