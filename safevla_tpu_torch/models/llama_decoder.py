"""LLaMA-style causal decoder with a KV cache, single-step decode.

Counterpart of `safevla_tpu/models/llama_decoder.py`: RMSNorm (eps 1e-5,
cast back before the weight multiply) -> attention -> residual -> RMSNorm ->
SwiGLU FFN -> residual; final RMSNorm and a bias-free projection back to
`dim`. No rotary embedding (time enters upstream as a sinusoidal encoding).
Module names follow the reference decoder (`layers.N.attention.wq`,
`feed_forward.w1`, `attention_norm`, `norm`, `output`).

Attention is plain torch matmul + softmax (XLA code in JAX, not a kernel):
f32 logits, -1e9 on masked slots, probabilities cast to the compute dtype,
f32-accumulated p.v. The single-step decode writes k/v at `pos` into the
cache IN PLACE (the JAX version returns a new cache); `full` is the update's
full-sequence path over a packed block-causal mask. Linear weights are f32,
cast to the compute dtype at use (flax Dense, `models/dense.py`).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from safevla_tpu_torch.models.dense import Dense


@dataclass(frozen=True)
class DecoderConfig:
    dim: int = 512
    n_layers: int = 3
    n_heads: int = 8
    multiple_of: int = 256
    norm_eps: float = 1e-5
    max_seq_len: int = 500
    dtype: torch.dtype = torch.bfloat16

    @property
    def head_dim(self) -> int:
        return self.dim // self.n_heads

    @property
    def ffn_hidden(self) -> int:
        # SwiGLU sizing (reference model.py:348-353): 4*dim -> 2/3 -> round up
        hidden = int(2 * (4 * self.dim) / 3)
        return self.multiple_of * ((hidden + self.multiple_of - 1) // self.multiple_of)


class RMSNorm(nn.Module):
    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))

    def forward(self, x):
        xf = x.float()
        normed = xf * torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + self.eps)
        return normed.to(x.dtype) * self.weight.to(x.dtype)


def _attend(q, k, v, mask, dtype):
    """q (B, Tq, H, Dh), k/v (B, Tk, H, Dh), mask (B, 1, Tq, Tk) bool or None."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if mask is not None:
        logits = torch.where(mask, logits, -1e9)
    probs = torch.softmax(logits, dim=-1).to(dtype)
    out = torch.einsum("bhqk,bkhd->bqhd", probs.float(), v.float())
    return out.to(dtype)


class Attention(nn.Module):
    def __init__(self, cfg: DecoderConfig):
        super().__init__()
        self.cfg = cfg
        d = cfg.dim
        self.wq = Dense(d, d, bias=False, compute_dtype=cfg.dtype)
        self.wk = Dense(d, d, bias=False, compute_dtype=cfg.dtype)
        self.wv = Dense(d, d, bias=False, compute_dtype=cfg.dtype)
        self.wo = Dense(d, d, bias=False, compute_dtype=cfg.dtype)

    def full(self, x, mask):
        """x (B, T, D); mask (B, 1, T, T) bool -> (B, T, D)."""
        b, t = x.shape[:2]
        h, dh = self.cfg.n_heads, self.cfg.head_dim
        q, k, v = (w(x).reshape(b, t, h, dh) for w in (self.wq, self.wk, self.wv))
        out = _attend(q, k, v, mask, self.cfg.dtype)
        return self.wo(out.reshape(b, t, self.cfg.dim))

    def step(self, x, cache_k, cache_v, pos: int, mask):
        """x (B, 1, D); cache_k/v (B, S, H, Dh), updated in place at slot pos."""
        b = x.shape[0]
        h, dh = self.cfg.n_heads, self.cfg.head_dim
        q = self.wq(x).reshape(b, 1, h, dh)
        cache_k[:, pos] = self.wk(x).reshape(b, h, dh)
        cache_v[:, pos] = self.wv(x).reshape(b, h, dh)
        out = _attend(q, cache_k, cache_v, mask, self.cfg.dtype)
        return self.wo(out.reshape(b, 1, self.cfg.dim))


class FeedForward(nn.Module):
    def __init__(self, cfg: DecoderConfig):
        super().__init__()
        hidden = cfg.ffn_hidden
        self.w1 = Dense(cfg.dim, hidden, bias=False, compute_dtype=cfg.dtype)
        self.w2 = Dense(hidden, cfg.dim, bias=False, compute_dtype=cfg.dtype)
        self.w3 = Dense(cfg.dim, hidden, bias=False, compute_dtype=cfg.dtype)

    def forward(self, x):
        return self.w2(F.silu(self.w1(x)) * self.w3(x))


class DecoderBlock(nn.Module):
    def __init__(self, cfg: DecoderConfig):
        super().__init__()
        self.attention = Attention(cfg)
        self.feed_forward = FeedForward(cfg)
        self.attention_norm = RMSNorm(cfg.dim, cfg.norm_eps)
        self.ffn_norm = RMSNorm(cfg.dim, cfg.norm_eps)

    def full(self, x, mask):
        h = x + self.attention.full(self.attention_norm(x), mask)
        return h + self.feed_forward(self.ffn_norm(h))

    def step(self, x, cache_k, cache_v, pos: int, mask):
        h = x + self.attention.step(self.attention_norm(x), cache_k, cache_v, pos, mask)
        return h + self.feed_forward(self.ffn_norm(h))


class LlamaDecoder(nn.Module):
    def __init__(self, cfg: DecoderConfig):
        super().__init__()
        self.cfg = cfg
        self.layers = nn.ModuleList(DecoderBlock(cfg) for _ in range(cfg.n_layers))
        self.norm = RMSNorm(cfg.dim, cfg.norm_eps)
        # bias-free projection back to dim (reference vocab_size == dim)
        self.output = Dense(cfg.dim, cfg.dim, bias=False, compute_dtype=cfg.dtype)

    def full(self, x, mask):
        """x (B, T, D); mask (B, 1, T, T) bool (packed block-causal) -> (B, T, D) f32."""
        h = x.to(self.cfg.dtype)
        for layer in self.layers:
            h = layer.full(h, mask)
        return self.output(self.norm(h)).float()

    def step(self, x, cache_k, cache_v, pos: int, mask):
        """x (B, 1, D); cache_k/v (L, B, S, H, Dh), written in place at slot
        pos; mask (B, 1, 1, S) bool -> (B, 1, D) f32."""
        h = x.to(self.cfg.dtype)
        for i, layer in enumerate(self.layers):
            h = layer.step(h, cache_k[i], cache_v[i], pos, mask)
        return self.output(self.norm(h)).float()

