"""Fusion transformer over [fusion token, camera patch tokens, text tokens].

Counterpart of `safevla_tpu/models/fusion.py`: torch `nn.TransformerEncoder`
semantics (post-LN, ReLU MLP, packed in_proj with biases), module names as
torch's (`layers.N.self_attn.in_proj_weight`, `linear1`, `norm1`, ...).

* Layers 0..n-2 run the packed-qkv attention kernel on the raw in_proj
  output, with per-row valid-key counts.
* The last layer can run for the first `out_rows` query rows only (the policy
  reads just the fused CLS): q, out-proj, residual, LN and MLP for those rows,
  K/V for all. That attention is XLA code in JAX, so here it is plain torch
  (`dense_attention`).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from safevla_tpu_torch.models.norms import CompatLayerNorm
from safevla_tpu_torch.ops.flash_attention import attention_qkv, dense_attention


class TorchMultiheadAttention(nn.Module):
    """nn.MultiheadAttention-compatible self-attention (in/out proj with bias)."""

    def __init__(self, dim: int, num_heads: int, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dim = dim
        self.num_heads = num_heads
        self.dtype = dtype
        # torch's packed (3d, d) in_proj: rows [q; k; v] give the [q|k|v]
        # output layout the kernel reads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * dim, dim, dtype=dtype))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * dim, dtype=dtype))
        self.out_proj = nn.Linear(dim, dim, dtype=dtype)

    def forward(self, x, key_lens=None, q_rows=None):
        b, t, d = x.shape
        h = self.num_heads
        if q_rows is None:
            qkv = F.linear(x, self.in_proj_weight, self.in_proj_bias)
            out = attention_qkv(qkv, h, key_lens=key_lens).to(self.dtype)
        else:
            # restricted-query attention: only the first q_rows outputs are
            # consumed, so q is projected for those rows alone
            q = F.linear(x[:, :q_rows], self.in_proj_weight[:d], self.in_proj_bias[:d])
            kv = F.linear(x, self.in_proj_weight[d:], self.in_proj_bias[d:])
            k, v = kv[..., :d], kv[..., d:]
            key_mask = None
            if key_lens is not None:
                key_mask = torch.arange(t, device=x.device)[None, :] < key_lens[:, None]
            fold = lambda z, n: z.reshape(b, n, h, d // h)
            out = dense_attention(fold(q, q_rows), fold(k, t), fold(v, t), key_mask)
            out = out.reshape(b, q_rows, d).to(self.dtype)
        return self.out_proj(out)


class FusionLayer(nn.Module):
    """One post-LN encoder layer (torch norm_first=False)."""

    def __init__(self, dim: int, num_heads: int, ffn_dim: int, dtype: torch.dtype):
        super().__init__()
        self.self_attn = TorchMultiheadAttention(dim, num_heads, dtype)
        self.linear1 = nn.Linear(dim, ffn_dim, dtype=dtype)
        self.linear2 = nn.Linear(ffn_dim, dim, dtype=dtype)
        self.norm1 = CompatLayerNorm(dim, out_dtype=dtype)
        self.norm2 = CompatLayerNorm(dim, out_dtype=dtype)

    def forward(self, x, key_lens=None, q_rows=None):
        attn = self.self_attn(x, key_lens, q_rows=q_rows)
        if q_rows is not None:
            # residual + LN + MLP only for the rows whose outputs are consumed
            x = x[:, :q_rows]
        x = self.norm1(x + attn)
        y = self.linear2(F.relu(self.linear1(x)))
        return self.norm2(x + y)


class FusionTransformer(nn.Module):
    def __init__(
        self,
        dim: int = 512,
        num_heads: int = 8,
        num_layers: int = 3,
        ffn_dim: int = 2048,
        dtype: torch.dtype = torch.bfloat16,
    ):
        super().__init__()
        self.dtype = dtype
        self.layers = nn.ModuleList(
            FusionLayer(dim, num_heads, ffn_dim, dtype) for _ in range(num_layers)
        )

    def forward(self, tokens, key_lens=None, out_rows=None):
        """tokens (B, N, D) -> (B, N, D), or (B, out_rows, D) when set.

        key_lens (B,) int32: valid-prefix count per row (right-padded text and
        the pad to a multiple of 16 are excluded from every softmax)."""
        x = tokens.to(self.dtype)
        for layer in self.layers[:-1]:
            x = layer(x, key_lens)
        return self.layers[-1](x, key_lens, q_rows=out_rows)
