"""Lagrange multiplier state and its projected ascent step.

Counterpart of `safevla_tpu/algo/lagrange.py`, with the semantics of
`omnisafe.common.lagrange.Lagrange`, which the reference uses for the
multiplier that couples the cost critic to the policy loss:

    lambda_loss = -lambda * (Jc - cost_limit)
    lambda     <- Adam step on lambda_loss, then projected to lambda >= 0

The multiplier, its Adam moments and the cost limit are 0-d f32 tensors on
the learner's device, so the ascent needs no host read. `update_lagrange`
returns a new state and leaves the one it was given as it was.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from safevla_tpu_torch.algo.optim import AdamState, adam_init, adam_step


@dataclass
class LagrangeState:
    multiplier: torch.Tensor  # 0-d f32, the raw value after the projection to >= 0
    opt_state: AdamState
    cost_limit: torch.Tensor  # 0-d f32
    upper_bound: Optional[float] = None


def init_lagrange(
    cost_limit: float,
    multiplier_init: float = 0.001,
    lr: float = 0.035,
    upper_bound: Optional[float] = None,
    device="cpu",
) -> LagrangeState:
    """`lr` is unused here (optax's Adam keeps no lr in its state); it is
    kept for the JAX signature."""
    init = torch.tensor(max(multiplier_init, 0.0), dtype=torch.float32, device=device)
    return LagrangeState(
        multiplier=init,
        opt_state=adam_init([init]),
        cost_limit=torch.tensor(cost_limit, dtype=torch.float32, device=device),
        upper_bound=upper_bound,
    )


def multiplier_value(state: LagrangeState) -> torch.Tensor:
    """The projected multiplier used in the policy loss."""
    m = torch.clamp(state.multiplier, min=0.0)
    if state.upper_bound is not None:
        m = torch.clamp(m, max=state.upper_bound)
    return m


def update_lagrange(
    state: LagrangeState, mean_episode_cost, lr: float = 0.035
) -> LagrangeState:
    """One ascent step towards E[cost] <= cost_limit."""
    cost = torch.as_tensor(mean_episode_cost, dtype=torch.float32, device=state.multiplier.device)
    grad = -(cost - state.cost_limit)  # d/dlambda of -lambda * (Jc - limit)
    mult = state.multiplier.clone()
    opt = AdamState(
        state.opt_state.count,
        [m.clone() for m in state.opt_state.mu],
        [n.clone() for n in state.opt_state.nu],
    )
    opt = adam_step([mult], [grad], opt, lr)
    return LagrangeState(
        multiplier=torch.clamp(mult, min=0.0),  # omnisafe projects after each step
        opt_state=opt,
        cost_limit=state.cost_limit,
        upper_bound=state.upper_bound,
    )
