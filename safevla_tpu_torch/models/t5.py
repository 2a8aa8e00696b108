"""T5 encoder (frozen text backbone) in PyTorch.

Counterpart of `safevla_tpu/models/t5.py`: RMS layer norms (no mean, no bias,
eps 1e-6), UNSCALED dot-product attention with a relative-position bias that
only block 0 owns and every block reuses, ReLU feed-forward, bias-free
linears, outputs zeroed at pads. Module names follow HuggingFace's
`T5EncoderModel` (`shared`, `encoder.block.N.layer.0.SelfAttention.q`, ...),
so its state dict loads by name. Runs once per episode.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


@dataclass(frozen=True)
class T5Config:
    vocab_size: int = 32128
    d_model: int = 512
    d_kv: int = 64
    d_ff: int = 2048
    num_layers: int = 6
    num_heads: int = 8
    relative_attention_num_buckets: int = 32
    relative_attention_max_distance: int = 128
    layer_norm_eps: float = 1e-6
    dtype: torch.dtype = torch.bfloat16


class T5LayerNorm(nn.Module):
    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))

    def forward(self, x):
        xf = x.float()
        xf = xf * torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + self.eps)
        # f32 weight times the input-dtype value promotes to f32, as in JAX
        return self.weight * xf.to(x.dtype)


def relative_position_bucket(
    relative_position: np.ndarray, num_buckets: int = 32, max_distance: int = 128
) -> np.ndarray:
    """Bidirectional T5 bucket function (static, computed with numpy)."""
    ret = np.zeros_like(relative_position)
    n = num_buckets // 2
    ret += (relative_position > 0).astype(np.int64) * n
    rp = np.abs(relative_position)
    max_exact = n // 2
    is_small = rp < max_exact
    val_if_large = max_exact + (
        np.log(np.maximum(rp, 1) / max_exact)
        / np.log(max_distance / max_exact)
        * (n - max_exact)
    ).astype(np.int64)
    val_if_large = np.minimum(val_if_large, n - 1)
    ret += np.where(is_small, rp, val_if_large)
    return ret


class T5Attention(nn.Module):
    def __init__(self, cfg: T5Config, has_relative_bias: bool = False):
        super().__init__()
        self.cfg = cfg
        inner = cfg.num_heads * cfg.d_kv
        self.q = nn.Linear(cfg.d_model, inner, bias=False, dtype=cfg.dtype)
        self.k = nn.Linear(cfg.d_model, inner, bias=False, dtype=cfg.dtype)
        self.v = nn.Linear(cfg.d_model, inner, bias=False, dtype=cfg.dtype)
        self.o = nn.Linear(inner, cfg.d_model, bias=False, dtype=cfg.dtype)
        self.has_relative_bias = has_relative_bias
        if has_relative_bias:
            self.relative_attention_bias = nn.Embedding(
                cfg.relative_attention_num_buckets, cfg.num_heads
            )

    def forward(self, x, mask, position_bias=None):
        cfg = self.cfg
        b, t, _ = x.shape
        x = x.to(cfg.dtype)
        q = self.q(x).reshape(b, t, cfg.num_heads, cfg.d_kv)
        k = self.k(x).reshape(b, t, cfg.num_heads, cfg.d_kv)
        v = self.v(x).reshape(b, t, cfg.num_heads, cfg.d_kv)
        # T5 attention is NOT scaled by sqrt(d_kv); f32 logits
        logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
        if self.has_relative_bias:
            pos = np.arange(t)
            buckets = relative_position_bucket(
                pos[None, :] - pos[:, None],
                cfg.relative_attention_num_buckets,
                cfg.relative_attention_max_distance,
            )
            idx = torch.from_numpy(buckets).to(x.device)
            position_bias = self.relative_attention_bias.weight[idx].permute(2, 0, 1)[None]
        if position_bias is not None:
            logits = logits + position_bias.float()
        if mask is not None:
            logits = torch.where(mask[:, None, None, :], logits, -1e9)
        probs = torch.softmax(logits, dim=-1).to(cfg.dtype)
        out = torch.einsum("bhqk,bkhd->bqhd", probs.float(), v.float())
        out = out.to(cfg.dtype).reshape(b, t, cfg.num_heads * cfg.d_kv)
        return self.o(out), position_bias


class T5LayerSelfAttention(nn.Module):
    def __init__(self, cfg: T5Config, has_relative_bias: bool):
        super().__init__()
        self.SelfAttention = T5Attention(cfg, has_relative_bias)
        self.layer_norm = T5LayerNorm(cfg.d_model, cfg.layer_norm_eps)

    def forward(self, x, mask, position_bias):
        y, position_bias = self.SelfAttention(self.layer_norm(x), mask, position_bias)
        return x + y, position_bias


class T5DenseReluDense(nn.Module):
    def __init__(self, cfg: T5Config):
        super().__init__()
        self.wi = nn.Linear(cfg.d_model, cfg.d_ff, bias=False, dtype=cfg.dtype)
        self.wo = nn.Linear(cfg.d_ff, cfg.d_model, bias=False, dtype=cfg.dtype)

    def forward(self, x):
        return self.wo(F.relu(self.wi(x)))


class T5LayerFF(nn.Module):
    def __init__(self, cfg: T5Config):
        super().__init__()
        self.DenseReluDense = T5DenseReluDense(cfg)
        self.layer_norm = T5LayerNorm(cfg.d_model, cfg.layer_norm_eps)
        self.dtype = cfg.dtype

    def forward(self, x):
        return x + self.DenseReluDense(self.layer_norm(x).to(self.dtype))


class T5Block(nn.Module):
    def __init__(self, cfg: T5Config, has_relative_bias: bool = False):
        super().__init__()
        self.layer = nn.ModuleList(
            [T5LayerSelfAttention(cfg, has_relative_bias), T5LayerFF(cfg)]
        )

    def forward(self, x, mask, position_bias=None):
        x, position_bias = self.layer[0](x, mask, position_bias)
        return self.layer[1](x), position_bias


class T5Stack(nn.Module):
    def __init__(self, cfg: T5Config):
        super().__init__()
        self.block = nn.ModuleList(
            T5Block(cfg, has_relative_bias=(i == 0)) for i in range(cfg.num_layers)
        )
        self.final_layer_norm = T5LayerNorm(cfg.d_model, cfg.layer_norm_eps)


class T5Encoder(nn.Module):
    """tokens (B, L) int, mask (B, L) bool -> last hidden state (B, L, d) f32."""

    def __init__(self, cfg: T5Config):
        super().__init__()
        self.cfg = cfg
        # gathered rows are cast to the compute dtype at use in JAX; storing
        # the table in it is the same numbers
        self.shared = nn.Embedding(cfg.vocab_size, cfg.d_model, dtype=cfg.dtype)
        self.encoder = T5Stack(cfg)

    def forward(self, tokens: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        x = self.shared(tokens.long())
        position_bias = None
        for blk in self.encoder.block:
            x, position_bias = blk(x, mask, position_bias)
        x = self.encoder.final_layer_norm(x)
        x = x * mask[..., None]  # zero padded positions
        return x.float()
