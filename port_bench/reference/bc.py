"""Plain PyTorch behaviour-cloning step, in float32: SPOC's offline trainer.

    instructions -> hash tokens -> the frozen SigLIP text tower
    uint8 frames of both cameras -> / 255 -> the drawn augmentation ->
    normalisation -> the frozen ViT (no gradient), in blocks of frames
    -> one tower over every step (one episode a row: a causal mask, the
       window's explicit previous actions) -> logits
    -> cross-entropy averaged over the targets that are not -1
    -> its gradient -> one AdamW step (optax.adamw: weight decay 1e-4 on
       every leaf, a leaf the loss does not reach included).
"""

from __future__ import annotations

from typing import Dict

import torch

from port_bench.reference import vision
from port_bench.reference.learner import adam_init, adam_step, blocked_grads
from port_bench.reference.tower import F32, Numerics

ADAMW_WEIGHT_DECAY = 1e-4
FRAME_BLOCK = 200  # frames a ViT block (no gradient)
STEP_BLOCK = 10  # time steps a fusion block


class BCLearner:
    """The reference BC trainer over one tower's f32 weights {"0.<name>": w}
    and the frozen encoders' weights."""

    def __init__(self, weights: Dict[str, torch.Tensor], vit_w, text_w, spec: dict, nm: Numerics = F32):
        self.params = {k: v.clone() for k, v in weights.items()}
        self.vit_w, self.text_w, self.spec, self.nm = vit_w, text_w, spec, nm
        self.opt = adam_init(self.params)

    @torch.no_grad()
    def features(self, frames: torch.Tensor, aug: Dict[str, float]) -> torch.Tensor:
        """frames (N, H, W, 3) uint8 -> (N, 7, 12, D) frozen features."""
        s = self.spec
        out = []
        for i in range(0, frames.shape[0], FRAME_BLOCK):
            x = vision.augment(frames[i : i + FRAME_BLOCK].float() / 255.0, aug)
            x = vision.normalise(x, s["rgb_means"], s["rgb_stds"])
            out.append(vision.vit(self.vit_w, s["vision"], x, self.nm, tuple(s["model"]["vision_grid"])))
        return torch.cat(out)

    def step(self, batch: Dict[str, torch.Tensor], instructions, aug: Dict[str, float], lr: float) -> float:
        """One BC step on a batch of (B, T, ...) device tensors -> its loss."""
        s, m = self.spec, self.spec["model"]
        b, t = batch["actions"].shape
        tokens, mask = vision.tokenize(instructions, m["text_max_tokens"])
        dev = batch["actions"].device
        tokens, mask = torch.from_numpy(tokens).to(dev), torch.from_numpy(mask).to(dev)
        with torch.no_grad():
            text_h = vision.text_tower(self.text_w, s["text"], tokens, mask, self.nm)
        frames = torch.cat([batch["rgb_nav"], batch["rgb_manip"]]).reshape((-1,) + batch["rgb_nav"].shape[2:])
        feats = self.features(frames, aug)
        feats = feats.reshape((2 * b, t) + feats.shape[1:])
        nav, manip = feats[:b], feats[b:]
        ones = torch.ones(b, t, dtype=torch.int32, device=dev)
        zeros = torch.zeros(b, t, dtype=torch.int32, device=dev)

        def embed(tw, c0, c1):
            n = c1 - c0
            fl = lambda x: x[:, c0:c1].reshape((-1,) + x.shape[2:])
            th = text_h.repeat_interleave(n, dim=0)
            tm = mask.repeat_interleave(n, dim=0)
            return tw.embed(fl(nav), fl(manip), th, tm).reshape(b, n, -1)

        def loss_of(towers, obs):
            logits, _ = towers[0].decode(obs[0], batch["last_actions"], ones, batch["an_object_is_in_hand"],
                                         batch["time_ids"], zeros)
            targets = batch["actions"].long()
            valid = targets != -1
            logp = torch.log_softmax(logits, -1).gather(-1, torch.where(valid, targets, 0)[..., None])[..., 0]
            return -(logp * valid).sum() / valid.sum().clamp(min=1)

        step = STEP_BLOCK
        while t % step:
            step -= 1
        loss, grads = blocked_grads(self.params, m, self.nm, 1, t, step, embed, loss_of)
        self.opt = adam_step(self.params, grads, self.opt, lr, weight_decay=ADAMW_WEIGHT_DECAY)
        return float(loss)
