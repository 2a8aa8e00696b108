"""Constrained-PPO loss functions.

Counterpart of `safevla_tpu/algo/losses.py`, with the reference losses of
training/online/loss/customized_loss.py behind it:
  * `safe_ppo_surrogate_loss`  <- SafePPOLogGrad.loss_per_step (l.317-414):
    clipped surrogate on the Lagrangian-penalized advantage
    (A - lambda * A_cost) / (1 + lambda), entropy bonus, value MSE.
  * `ppo_surrogate_loss`       <- PPOLogGrad (l.163-298), the lambda == 0 path.
  * `value_loss`               <- PPOValue / SafePPOValue (plain or clipped MSE).
  * `imitation_bce_loss`       <- Imitation (l.17-83): BCE of one action logit
    against an expert binary signal.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F


def categorical_log_prob(logits: torch.Tensor, actions: torch.Tensor) -> torch.Tensor:
    logp = F.log_softmax(logits, dim=-1)
    return torch.gather(logp, -1, actions.long()[..., None])[..., 0]


def categorical_entropy(logits: torch.Tensor) -> torch.Tensor:
    logp = F.log_softmax(logits, dim=-1)
    return -(torch.exp(logp) * logp).sum(dim=-1)


def clipped_surrogate(
    log_probs: torch.Tensor, old_log_probs: torch.Tensor, advantage: torch.Tensor,
    clip_param: float,
) -> torch.Tensor:
    """Per-step pessimistic clipped surrogate: -min(r*A, clip(r)*A)."""
    ratio = torch.exp(log_probs - old_log_probs)
    clamped = torch.clamp(ratio, 1.0 - clip_param, 1.0 + clip_param)
    return -torch.minimum(ratio * advantage, clamped * advantage)


def value_loss(
    values: torch.Tensor,
    returns: torch.Tensor,
    old_values: Optional[torch.Tensor] = None,
    clip_param: float = 0.1,
    use_clipped: bool = False,
) -> torch.Tensor:
    """0.5 * MSE (optionally pessimistically clipped around old values)."""
    if use_clipped and old_values is not None:
        clipped = old_values + torch.clamp(values - old_values, -clip_param, clip_param)
        return 0.5 * torch.maximum((values - returns) ** 2, (clipped - returns) ** 2).mean()
    return 0.5 * ((returns - values) ** 2).mean()


def ppo_surrogate_loss(
    logits, values, actions, old_log_probs, advantages, returns, old_values,
    clip_param: float = 0.1, value_loss_coef: float = 0.5, entropy_coef: float = 0.0,
    use_clipped_value_loss: bool = False,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    log_probs = categorical_log_prob(logits, actions)
    action_loss = clipped_surrogate(log_probs, old_log_probs, advantages, clip_param).mean()
    entropy = categorical_entropy(logits).mean()
    v_loss = value_loss(values, returns, old_values, clip_param, use_clipped_value_loss)
    total = action_loss + value_loss_coef * v_loss - entropy_coef * entropy
    return total, {"action": action_loss, "value": v_loss, "entropy": entropy, "ppo_total": total}


def safe_ppo_surrogate_loss(
    logits, values, actions, old_log_probs, advantages, c_advantages, returns, old_values,
    lagrange_multiplier, clip_param: float = 0.1, value_loss_coef: float = 0.5,
    entropy_coef: float = 0.0, use_clipped_value_loss: bool = False,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """PPO-Lagrangian surrogate (reference customized_loss.py:348-362)."""
    penalty = torch.as_tensor(lagrange_multiplier).detach()
    penalized_adv = (advantages - penalty * c_advantages) / (1.0 + penalty)
    log_probs = categorical_log_prob(logits, actions)
    action_loss = clipped_surrogate(log_probs, old_log_probs, penalized_adv, clip_param).mean()
    entropy = categorical_entropy(logits).mean()
    v_loss = value_loss(values, returns, old_values, clip_param, use_clipped_value_loss)
    total = action_loss + value_loss_coef * v_loss - entropy_coef * entropy
    return total, {
        "action": action_loss, "value": v_loss, "entropy": entropy,
        "penalty": penalty, "ppo_total": total,
    }


def imitation_bce_loss(
    logits: torch.Tensor, expert_signal: torch.Tensor, action_idx: int = 8
) -> torch.Tensor:
    """BCE of the pickup-action logit vs a binary expert signal
    (reference customized_loss.py:63-69), in the numerically stable form."""
    x = logits[..., action_idx]
    return (torch.clamp(x, min=0) - x * expert_signal + torch.log1p(torch.exp(-x.abs()))).mean()
