"""Transformer-free visual fusion encoder of the offline IL model family.

Counterpart of `safevla_tpu/models/visual_encoders.py` (the reference's
`NonTxMultiCameraVisualEncoder`): each camera's frozen-encoder grid is
compressed with 1x1 convs, the mean-pooled instruction embedding joins as
extra channels, more 1x1 convs combine them, and each time step flattens to
one token.

Every 1x1 conv is a matmul over the channel axis of the channels-last grid,
with its weights shared across cameras (the cameras are stacked into the
batch). The convs keep the reference's (out, in, 1, 1) weights and names
(`visual_compressor.0/2`, `image_text_combiner.0/2`); the adapters are
Linear -> LayerNorm -> ReLU (`text_adapter`, `text_adapter_for_combiner`,
`final_adapter`, each `.0` / `.1`). Parameters are f32 and cast to the
compute dtype at use, as flax's Dense; the adapter norms are flax
`nn.LayerNorm` (f32, eps 1e-6) in the JAX package, so `PlainLayerNorm` here.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from safevla_tpu_torch.models.dense import Dense, cast_param
from safevla_tpu_torch.models.norms import PlainLayerNorm


@dataclass(frozen=True)
class NonTxEncoderConfig:
    """Mirrors the reference's NonTxVisualEncoderConfig (defaults included)."""

    compressor_hidden_dims: Tuple[int, int] = (128, 32)
    text_adapter_output_dim: int = 32
    image_text_combiner_hidden_dims: Tuple[int, int] = (64, 32)
    final_out_dim: int = 512
    pool_grid: Tuple[int, int] = (7, 12)
    dtype: torch.dtype = torch.bfloat16


class _Adapter(nn.Sequential):
    """Linear -> LayerNorm -> ReLU, out in the compute dtype."""

    def __init__(self, din: int, dout: int, dtype: torch.dtype):
        super().__init__(Dense(din, dout, compute_dtype=dtype), PlainLayerNorm(dout), nn.ReLU())
        self.dtype = dtype

    def forward(self, x):
        return super().forward(x).to(self.dtype)


def _conv1x1(convs, x, dtype):
    """The Sequential's 1x1 convs (+ ReLU each) as matmuls over x's last axis."""
    for conv in convs:
        x = F.relu(F.linear(x, cast_param(conv.weight, dtype).flatten(1), cast_param(conv.bias, dtype)))
    return x


class NonTxVisualEncoder(nn.Module):
    """frames {camera: (B, T, gh, gw, C)} frozen-encoder grids, text_hidden
    (B, L, Dt) -> (fused (B, T, final_out_dim) f32, text_feats (B, L,
    final_out_dim) f32). `visual_dim` is C, `text_dim` Dt."""

    def __init__(self, cfg: NonTxEncoderConfig, visual_dim: int, text_dim: int, num_cameras: int = 2):
        super().__init__()
        self.cfg = cfg
        c0, c1 = cfg.compressor_hidden_dims
        k0, k1 = cfg.image_text_combiner_hidden_dims
        gh, gw = cfg.pool_grid
        dt = cfg.dtype
        self.text_adapter = _Adapter(text_dim, cfg.final_out_dim, dt)
        self.text_adapter_for_combiner = _Adapter(cfg.final_out_dim, cfg.text_adapter_output_dim, dt)
        self.visual_compressor = nn.Sequential(
            nn.Conv2d(visual_dim, c0, 1), nn.ReLU(), nn.Conv2d(c0, c1, 1), nn.ReLU()
        )
        self.image_text_combiner = nn.Sequential(
            nn.Conv2d(c1 + cfg.text_adapter_output_dim, k0, 1), nn.ReLU(), nn.Conv2d(k0, k1, 1), nn.ReLU()
        )
        self.final_adapter = _Adapter(num_cameras * gh * gw * k1, cfg.final_out_dim, dt)

    def forward(self, frames: Dict[str, torch.Tensor], text_hidden: torch.Tensor):
        dt = self.cfg.dtype
        cameras = sorted(frames)
        b, t, gh, gw, _ = frames[cameras[0]].shape
        text_feats = self.text_adapter(text_hidden.to(dt))
        txt = self.text_adapter_for_combiner(text_feats).mean(dim=1)  # (B, D)
        x = torch.stack([frames[c] for c in cameras]).to(dt)  # (cams, B, T, gh, gw, C)
        x = _conv1x1(self.visual_compressor[::2], x, dt)
        txt = txt[None, :, None, None, None, :].expand(*x.shape[:-1], txt.shape[-1])
        x = _conv1x1(self.image_text_combiner[::2], torch.cat([x, txt], dim=-1), dt)
        fused = self.final_adapter(torch.cat([xc.reshape(b, t, -1) for xc in x], dim=-1))
        return fused.float(), text_feats.float()
