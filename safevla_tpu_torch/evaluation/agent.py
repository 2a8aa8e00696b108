"""Batched inference agent: the policy driven step by step over B streams.

Counterpart of `safevla_tpu/evaluation/agent.py::InferenceAgent` (reference
`InferenceAgentVIDA`, inference_agent.py:85-296): one batched act serves all
eval streams, with KV-cache incremental decode and greedy or sampled actions.
Per act: one packed upload of both cameras' uint8 frames, one int32 upload
(previous action, not-reset flag, object-in-hand), then augment ->
normalise -> ViT -> three towers -> action, and one action fetch.

Checkpoint restore (Orbax directories, reference torch files) is not ported
yet: `build` raises NotImplementedError for a path.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from safevla_tpu_torch.config import Config
from safevla_tpu_torch.constants import rgb_norm_constants
from safevla_tpu_torch.models.actor_critic import SafeVLAPolicy
from safevla_tpu_torch.preprocessing.augment import (
    apply_augment,
    identity_augment_params,
    sample_augment_params,
)
from safevla_tpu_torch.preprocessing.tokenize import InstructionTokenizer


class InferenceAgent:
    def __init__(
        self,
        cfg: Config,
        policy: SafeVLAPolicy,
        num_streams: int,
        mode: str = "greedy",
        seed: int = 123,
        test_augmentation: bool = True,
        max_episode_steps: Optional[int] = None,
        require_exact_tokenizer: bool = False,
    ):
        if mode not in ("greedy", "sample"):
            raise ValueError(f"mode must be 'greedy' or 'sample', not {mode!r}")
        if max_episode_steps and max_episode_steps > cfg.model.max_steps:
            # the KV cache must cover the longest eval episode or the decode
            # slot silently wraps mid-episode (train default 500 < 600/1000-
            # step eval caps); guarded here so no caller can bypass it
            cfg = dataclasses.replace(
                cfg, model=dataclasses.replace(cfg.model, max_steps=max_episode_steps)
            )
            policy.cfg = cfg.model
        self.cfg = cfg
        self.policy = policy
        self.device = policy.device
        self.B = num_streams
        self.mode = mode
        self.rng = torch.Generator(device=self.device).manual_seed(seed)
        self.tokenizer = InstructionTokenizer(
            cfg.model.text_backbone,
            cfg.model.text_max_tokens,
            require_exact=require_exact_tokenizer,
        )
        self.test_augmentation = test_augmentation
        self._aug_gen = torch.Generator().manual_seed(seed + 7)
        self.aug_params = identity_augment_params()
        self._aug_steps = 0
        self.state = policy.init_state(self.B, cfg.model.text_max_tokens)
        self.instructions = [""] * self.B
        self.prev_action = np.zeros(self.B, np.int32)
        self._text_ready = False
        self._last_probs = None
        self._last_values = None
        means, stds = rgb_norm_constants(cfg.model.vision_backbone)
        self._means = torch.tensor(means, dtype=torch.float32, device=self.device)
        self._stds = torch.tensor(stds, dtype=torch.float32, device=self.device)

    @torch.no_grad()
    def _step(self, state, aug, imgs_u8, ints):
        """One batched act on the device: imgs_u8 (2B, H, W, 3) uint8 (nav
        frames then manipulation frames), ints (3, B) int32."""
        prev, not_reset, oih = ints[0], ints[1], ints[2]
        x01 = apply_augment(imgs_u8.float() / 255.0, aug)
        x = (x01 - self._means) / self._stds
        feats = self.policy.encode_images(x)
        logits, v, cv, new_state = self.policy.act_step(
            state, feats[: self.B], feats[self.B :], prev, not_reset, oih
        )
        if self.mode == "greedy":
            action = torch.argmax(logits, dim=-1)
        else:  # Gumbel-max draw from the agent's generator
            u = torch.rand(logits.shape, generator=self.rng, device=logits.device)
            u = torch.clamp(u, min=torch.finfo(torch.float32).tiny)
            action = torch.argmax(logits - torch.log(-torch.log(u)), dim=-1)
        return action, torch.softmax(logits, dim=-1), v, cv, new_state

    # ------------------------------------------------------------------
    @torch.no_grad()
    def set_instructions(self, instructions: List[Optional[str]]):
        """Install instructions for streams whose episode just reset (runs
        the T5 encoder once for the batch when any instruction changed)."""
        changed = False
        for i, ins in enumerate(instructions):
            if ins is not None and ins != self.instructions[i]:
                self.instructions[i] = ins
                changed = True
        if changed or not self._text_ready:
            tokens, mask = self.tokenizer.encode_batch(self.instructions)
            tokens = torch.from_numpy(tokens).to(self.device)
            mask = torch.from_numpy(mask).to(self.device)
            hidden = self.policy.encode_text(tokens, mask)
            self.state = dataclasses.replace(self.state, text_hidden=hidden, text_mask=mask)
            self._text_ready = True

    def act(self, rgb_nav, rgb_manip, not_reset, oih) -> np.ndarray:
        """One batched act. Arrays are host uint8 / int; returns actions (B,)."""
        if self.test_augmentation:
            if self._aug_steps % self.cfg.train.max_steps == 0:
                self.aug_params = sample_augment_params(
                    self._aug_gen, version=self.cfg.train.augmentation_version
                )
            self._aug_steps += 1
        ints = np.stack(
            [self.prev_action, np.asarray(not_reset, np.int32), np.asarray(oih, np.int32)]
        ).astype(np.int32)
        frames = torch.from_numpy(np.concatenate([rgb_nav, rgb_manip], axis=0))
        action, self._last_probs, v, cv, self.state = self._step(
            self.state,
            self.aug_params,
            frames.to(self.device),
            torch.from_numpy(ints).to(self.device),
        )
        self._last_values = (v, cv)
        out = action.cpu().numpy().astype(np.int32)
        self.prev_action = out.copy()
        return out

    @property
    def last_probs(self) -> Optional[np.ndarray]:
        """Action distribution of the last act (fetched on demand)."""
        if self._last_probs is None:
            return None
        return self._last_probs.cpu().numpy()

    @property
    def last_values(self) -> Optional[tuple]:
        """(values, cost values) of the last act, each (B,) (fetched on demand)."""
        if self._last_values is None:
            return None
        return tuple(x.cpu().numpy() for x in self._last_values)

    def reset_streams(self, reset_mask: np.ndarray):
        """Zero prev-action for reset streams (the cache is masked by the
        episode-window attention mask, as in training)."""
        self.prev_action[reset_mask] = 0

    # ------------------------------------------------------------------
    @classmethod
    def build(
        cls,
        cfg: Config,
        ckpt_path: Optional[str],
        num_streams: int,
        mode: str = "greedy",
        seed: int = 123,
        test_augmentation: bool = True,
        max_episode_steps: Optional[int] = None,
        require_exact_tokenizer: bool = False,
        device="cuda",
    ) -> "InferenceAgent":
        """Random-init agent (weights from a generator seeded with `seed`) on
        `device`; raises when device="cuda" and CUDA is absent."""
        if ckpt_path:
            raise NotImplementedError(
                "checkpoint restore (Orbax or reference torch files) is not ported yet"
            )
        policy = SafeVLAPolicy(
            cfg.model, device=device, generator=torch.Generator().manual_seed(seed)
        )
        policy.requires_grad_(False)
        return cls(
            cfg, policy, num_streams, mode, seed, test_augmentation,
            max_episode_steps=max_episode_steps,
            require_exact_tokenizer=require_exact_tokenizer,
        )
