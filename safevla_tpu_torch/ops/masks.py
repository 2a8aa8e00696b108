"""Attention masks for packed rollouts and incremental decode.

Counterpart of `safevla_tpu/ops/masks.py` (True = attend):
  * update path: tril of traj_idx[i] == traj_idx[j]
    (reference: allenact_dino_transformer.py:398-402)
  * rollout path: attend from the episode-start cache slot to the current one
    (reference: allenact_dino_transformer.py:388-397)
and `additive`, a boolean mask as an additive bias.
"""

from __future__ import annotations

import torch


def packed_block_causal_mask(traj_idx: torch.Tensor) -> torch.Tensor:
    """traj_idx (B, T) int -> (B, 1, T, T) bool:
    mask[b, 0, i, j] = (traj_idx[b, i] == traj_idx[b, j]) and j <= i."""
    same = traj_idx[:, :, None] == traj_idx[:, None, :]
    t = traj_idx.shape[-1]
    causal = torch.ones((t, t), dtype=torch.bool, device=traj_idx.device).tril()
    return (same & causal)[:, None]


def incremental_episode_mask(
    time_step: torch.Tensor, cache_pos, max_len: int
) -> torch.Tensor:
    """Single-token decode mask over the KV cache.

    time_step (B,): steps taken in the current episode (0 on reset).
    cache_pos: int or (B,) tensor, the write slot of the current token; the
    cache slot is shared by all streams and wraps at max_len.
    Returns (B, 1, 1, max_len) bool: slots [cache_pos - time_step, cache_pos].
    """
    cache_pos = torch.as_tensor(cache_pos, device=time_step.device).expand(time_step.shape)
    epi_start = torch.clamp(cache_pos - time_step, min=0)
    slots = torch.arange(max_len, device=time_step.device)
    ok = (slots[None, :] >= epi_start[:, None]) & (slots[None, :] <= cache_pos[:, None])
    return ok[:, None, None, :]


def additive(mask: torch.Tensor, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """bool mask -> additive bias in `dtype`: 0 where allowed, -1e9 elsewhere."""
    return torch.where(mask, 0.0, -1e9).to(dtype)
