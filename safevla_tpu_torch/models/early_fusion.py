"""Early-fusion IL model API shim.

Counterpart of `safevla_tpu/models/early_fusion.py`. The reference's offline
model is `EarlyFusionCnnTransformer` with `build_model` / `mock_batch` /
`forward -> {actions_logits, loss}` / `build_agent` (reference
architecture/models/transformer_models/early_fusion_tsfm_models.py:49-490).
Here the offline model IS the online PolicyTower (see training/offline.py),
so this module is a thin API-compatibility layer over the shared tower with
one tower.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import numpy as np
import torch

from safevla_tpu_torch.config import Config, ModelConfig
from safevla_tpu_torch.constants import DINO_RGB_MEANS, DINO_RGB_STDS
from safevla_tpu_torch.models.actor_critic import SafeVLAPolicy
from safevla_tpu_torch.preprocessing.tokenize import InstructionTokenizer
from safevla_tpu_torch.training.offline import cross_entropy_ignore_index


class EarlyFusionCnnTransformer:
    """Reference-shaped facade over the shared policy tower (num_towers=1),
    its weights drawn from a generator seeded with `seed`."""

    def __init__(self, cfg: Optional[ModelConfig] = None, seed: int = 0, device="cuda"):
        self.cfg = dataclasses.replace(cfg or ModelConfig(), num_towers=1)
        self.policy = SafeVLAPolicy(
            self.cfg, device=device, generator=torch.Generator().manual_seed(seed)
        )
        self.policy.requires_grad_(False)
        self.tokenizer = InstructionTokenizer(self.cfg.text_backbone, self.cfg.text_max_tokens)

    @classmethod
    def build_model(cls, model_version: str = "base", **kwargs) -> "EarlyFusionCnnTransformer":
        return cls(**kwargs)

    @classmethod
    def build_agent(cls, ckpt_path: Optional[str] = None, mode: str = "greedy",
                    num_streams: int = 1, cfg: Optional[Config] = None, device="cuda", **kwargs):
        """Streaming inference agent (reference EarlyFusionCnnTransformerAgent):
        the port's `InferenceAgent.build` with one tower; `kwargs` go to it."""
        from safevla_tpu_torch.evaluation.agent import InferenceAgent

        cfg = cfg or Config()
        cfg.model = dataclasses.replace(cfg.model, num_towers=1)
        return InferenceAgent.build(
            cfg, ckpt_path, num_streams=num_streams, mode=mode, device=device, **kwargs
        )

    # ------------------------------------------------------------------
    def mock_batch(self, B: int = 2, T: int = 10) -> Dict[str, Any]:
        """Synthetic batch for shape-level smoke testing
        (reference early_fusion_tsfm_models.py:104-115)."""
        h, w = self.cfg.image_size
        rng = np.random.default_rng(0)
        return {
            "rgb_nav": rng.integers(0, 255, (B, T, h, w, 3), dtype=np.uint8),
            "rgb_manip": rng.integers(0, 255, (B, T, h, w, 3), dtype=np.uint8),
            "last_actions": np.full((B, T), self.cfg.num_actions, np.int32),
            "actions": rng.integers(0, self.cfg.num_actions, (B, T)).astype(np.int32),
            "time_ids": np.tile(np.arange(T, dtype=np.int32), (B, 1)),
            "an_object_is_in_hand": np.zeros((B, T), np.int32),
            "padding_mask": np.zeros((B, T), bool),
            "instructions": ["go to a mug"] * B,
        }

    def _forward_impl(self, batch):
        b, t = batch["rgb_nav"].shape[:2]
        dev = self.policy.device
        imgs = torch.cat([batch["rgb_nav"], batch["rgb_manip"]], dim=0)
        imgs = imgs.reshape((-1,) + imgs.shape[2:])
        means = torch.tensor(DINO_RGB_MEANS, dtype=torch.float32, device=dev)
        stds = torch.tensor(DINO_RGB_STDS, dtype=torch.float32, device=dev)
        x = (imgs.float() / 255.0 - means) / stds
        feats = self.policy.encode_images(x)
        feats = feats.reshape((2 * b, t) + feats.shape[1:])
        out = self.policy.forward_seq(
            feats[:b],
            feats[b:],
            batch["text_hidden"],
            batch["text_mask"],
            batch["last_actions"],
            torch.ones((b, t), dtype=torch.int32, device=dev),
            batch["an_object_is_in_hand"],
            batch["time_ids"],
            torch.zeros((b, t), dtype=torch.int32, device=dev),
        )
        loss = cross_entropy_ignore_index(out.logits, batch["actions"])
        return {"actions_logits": out.logits, "actions_loss": loss, "loss": loss}

    @torch.no_grad()
    def forward(self, batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        """Logits and the BC loss of a host batch (as `mock_batch` makes),
        computed on the policy's device without autograd."""
        dev = self.policy.device
        tokens, mask = self.tokenizer.encode_batch(batch["instructions"])
        to = lambda a: torch.as_tensor(np.asarray(a), device=dev)
        device_batch = {
            k: to(batch[k])
            for k in ("rgb_nav", "rgb_manip", "last_actions", "actions", "time_ids", "an_object_is_in_hand")
        }
        device_batch["text_mask"] = to(mask)
        device_batch["text_hidden"] = self.policy.encode_text(to(tokens), device_batch["text_mask"])
        return self._forward_impl(device_batch)

    __call__ = forward
