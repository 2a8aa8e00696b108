"""Generalized Advantage Estimation as a reverse loop over time.

Counterpart of `safevla_tpu/ops/gae.py` (a reverse `lax.scan` there). Reward
and cost advantages share one loop over a stacked (K, T, B) tensor.

Mask convention (allenact / ikostrikov storage layout):
  rewards:  (T, B)   reward received after step t
  values:   (T+1, B) value predictions incl. the bootstrap value at T
  masks:    (T+1, B) masks[t] == 0 iff a new episode begins at step t
                     (so masks[t+1] == 0 cuts the return after step t)
"""

from __future__ import annotations

from typing import Tuple

import torch


def gae_advantages(
    rewards: torch.Tensor, values: torch.Tensor, masks: torch.Tensor,
    gamma: float, gae_lambda: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (advantages, returns), each (T, B)."""
    adv, ret = dual_gae(rewards[None], values[None], masks, gamma, gae_lambda)
    return adv[0], ret[0]


def dual_gae(
    rewards_stack: torch.Tensor, values_stack: torch.Tensor, masks: torch.Tensor,
    gamma: float, gae_lambda: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """GAE over K parallel signals sharing one mask (K=2 for reward + cost).

    rewards_stack (K, T, B), values_stack (K, T+1, B), masks (T+1, B).
    Returns (advantages, returns), each (K, T, B)."""
    t = rewards_stack.shape[1]
    cur_values = values_stack[:, :-1]
    next_masks = masks[1:].to(rewards_stack.dtype)  # (T, B)
    deltas = rewards_stack + gamma * values_stack[:, 1:] * next_masks[None] - cur_values
    gae = torch.zeros_like(deltas[:, 0])
    adv = [None] * t
    for i in range(t - 1, -1, -1):
        gae = deltas[:, i] + gamma * gae_lambda * next_masks[i][None] * gae
        adv[i] = gae
    advantages = torch.stack(adv, dim=1)
    return advantages, advantages + cur_values
