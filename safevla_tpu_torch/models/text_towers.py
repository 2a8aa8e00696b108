"""Alternative text tower: the SigLIP text transformer (frozen).

Counterpart of `safevla_tpu/models/text_towers.py` (the reference's "siglip"
text encoder, open_clip's TextTransformer): learned token and position
embeddings, pre-LN blocks, exact-GELU MLP, final LN, returning the full
hidden sequence (the fusion transformer reads token sequences).

Same numerics as the JAX module:
  * the token and position embeddings are f32 and summed in f32, then cast
    to the compute dtype;
  * LayerNorms are f32 (eps 1e-6, flax's fast variance: `PlainLayerNorm`),
    each output cast to the compute dtype before the next matmul;
  * attention is plain masked attention: q.k in f32 from compute-dtype
    inputs, -1e9 on masked keys, softmax in f32, then a cast to the compute
    dtype. The JAX module computes it and its LayerNorms outside any Pallas
    kernel, so neither goes through the port's kernels;
  * the output is multiplied by the mask, in f32.

Ids at or above the vocabulary (the hash tokenizer's vocabulary is 32128,
the tower's 32000) are clamped to the last row, as JAX's gather clamps them;
`nn.Embedding` would raise on them.

Module names are open_clip's (`token_embedding`, `positional_embedding`,
`transformer.resblocks.N.{ln_1, attn.in_proj_weight, attn.in_proj_bias,
attn.out_proj, ln_2, mlp.c_fc, mlp.c_proj}`, `ln_final`), so the JAX
package's `convert.import_siglip_text` reads a port state dict. Linear
weights are stored in the compute dtype, as the ViT's.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from safevla_tpu_torch.models.norms import PlainLayerNorm


@dataclass(frozen=True)
class TextTowerConfig:
    vocab_size: int = 32000
    d_model: int = 768
    num_layers: int = 12
    num_heads: int = 12
    mlp_ratio: float = 4.0
    max_tokens: int = 64
    layer_norm_eps: float = 1e-6
    dtype: torch.dtype = torch.bfloat16


class TextAttention(nn.Module):
    """torch MultiheadAttention's packed parameters, plain masked attention."""

    def __init__(self, cfg: TextTowerConfig):
        super().__init__()
        d = cfg.d_model
        self.num_heads = cfg.num_heads
        self.dtype = cfg.dtype
        self.in_proj_weight = nn.Parameter(torch.empty(3 * d, d, dtype=cfg.dtype))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * d, dtype=cfg.dtype))
        self.out_proj = nn.Linear(d, d, dtype=cfg.dtype)

    def forward(self, x, mask):
        b, t, d = x.shape
        h = self.num_heads
        dh = d // h
        qkv = F.linear(x, self.in_proj_weight, self.in_proj_bias).reshape(b, t, 3, h, dh)
        q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))  # (B, H, T, Dh)
        # products of compute-dtype inputs, summed in f32
        logits = q.float() @ k.float().transpose(-1, -2) / math.sqrt(dh)
        logits = logits.masked_fill(~mask[:, None, None, :], -1e9)
        p = torch.softmax(logits, dim=-1).to(self.dtype)
        attn = (p @ v).transpose(1, 2).reshape(b, t, d)
        return self.out_proj(attn)


class _Mlp(nn.Module):
    def __init__(self, cfg: TextTowerConfig):
        super().__init__()
        hidden = int(cfg.d_model * cfg.mlp_ratio)
        self.c_fc = nn.Linear(cfg.d_model, hidden, dtype=cfg.dtype)
        self.c_proj = nn.Linear(hidden, cfg.d_model, dtype=cfg.dtype)

    def forward(self, x):
        # exact GELU, as open_clip's nn.GELU
        return self.c_proj(F.gelu(self.c_fc(x), approximate="none"))


class _Block(nn.Module):
    def __init__(self, cfg: TextTowerConfig):
        super().__init__()
        self.dtype = cfg.dtype
        self.ln_1 = PlainLayerNorm(cfg.d_model, eps=cfg.layer_norm_eps)
        self.attn = TextAttention(cfg)
        self.ln_2 = PlainLayerNorm(cfg.d_model, eps=cfg.layer_norm_eps)
        self.mlp = _Mlp(cfg)

    def forward(self, x, mask):
        x = x + self.attn(self.ln_1(x).to(self.dtype), mask)
        return x + self.mlp(self.ln_2(x).to(self.dtype))


class _Transformer(nn.Module):
    def __init__(self, cfg: TextTowerConfig):
        super().__init__()
        self.resblocks = nn.ModuleList(_Block(cfg) for _ in range(cfg.num_layers))


class SigLIPTextEncoder(nn.Module):
    """tokens (B, L) int, mask (B, L) bool -> hidden (B, L, D) f32."""

    def __init__(self, cfg: TextTowerConfig):
        super().__init__()
        self.cfg = cfg
        self.token_embedding = nn.Embedding(cfg.vocab_size, cfg.d_model)
        self.positional_embedding = nn.Parameter(torch.zeros(cfg.max_tokens, cfg.d_model))
        self.transformer = _Transformer(cfg)
        self.ln_final = PlainLayerNorm(cfg.d_model, eps=cfg.layer_norm_eps)

    def forward(self, tokens: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        mask = mask.bool()
        ids = tokens.long().clamp(0, cfg.vocab_size - 1)  # JAX's gather clamps
        x = self.token_embedding.weight[ids] + self.positional_embedding[None, : tokens.shape[1]]
        x = x.to(cfg.dtype)
        for blk in self.transformer.resblocks:
            x = blk(x, mask)
        return self.ln_final(x) * mask[..., None]
