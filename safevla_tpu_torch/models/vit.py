"""DINOv2-style ViT (frozen vision backbone) in PyTorch.

Counterpart of `safevla_tpu/models/vit.py`: 224x384 input, centre width crop
to 378, 14x14 patchify -> 16x27 patch tokens (+ CLS) -> 12 pre-LN blocks with
LayerScale -> final norm -> adaptive average pool to a (7, 12) grid.

Same numerics as the JAX module:
  * patchify is a reshape + one matmul (bf16 inputs, f32 accumulation, f32
    bias) on the conv-layout kernel; module names follow torch-hub DINOv2
    (`patch_embed.proj`, `blocks.N.attn.qkv`, `blocks.N.ls1.gamma`, ...), so
    the patch kernel is stored as the hub's (D, 3, P, P) conv weight;
  * `pos_embed` is stored already interpolated for 1 + 16*27 tokens;
  * tokens are padded once, 433 -> 448, and the pad is masked out of every
    softmax with key_lens = 433 (the packed-qkv attention kernel);
  * GELU is the tanh form in bf16 and the erf form in f32;
  * the final norm outputs f32; pooling uses two static pool matrices.
Linear weights are stored in the compute dtype (casting once at load equals
the JAX module's cast at every use).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from safevla_tpu_torch.models.norms import CompatLayerNorm
from safevla_tpu_torch.ops.flash_attention import attention_qkv


@dataclass(frozen=True)
class DinoViTConfig:
    patch_size: int = 14
    embed_dim: int = 384  # ViT-S
    depth: int = 12
    num_heads: int = 6
    mlp_ratio: float = 4.0
    img_height: int = 224
    img_width: int = 378  # after centre width crop from 384
    layerscale: bool = True
    use_cls_token: bool = True  # False for SigLIP-style patch-only trunks
    dtype: torch.dtype = torch.bfloat16

    @property
    def grid(self) -> tuple[int, int]:
        return self.img_height // self.patch_size, self.img_width // self.patch_size

    @property
    def num_patches(self) -> int:
        gh, gw = self.grid
        return gh * gw


def adaptive_pool_matrix(in_size: int, out_size: int) -> np.ndarray:
    """Exact torch AdaptiveAvgPool1d bin weights as an (out, in) matrix."""
    m = np.zeros((out_size, in_size), dtype=np.float32)
    for i in range(out_size):
        start = (i * in_size) // out_size
        end = -(-((i + 1) * in_size) // out_size)  # ceil
        m[i, start:end] = 1.0 / (end - start)
    return m


class Attention(nn.Module):
    def __init__(self, cfg: DinoViTConfig):
        super().__init__()
        d = cfg.embed_dim
        self.num_heads = cfg.num_heads
        self.dtype = cfg.dtype
        # timm's qkv layout is (3, heads, head_dim) on the output axis: q is
        # lanes [0:d], the packed [q|k|v] form the kernel reads in place
        self.qkv = nn.Linear(d, 3 * d, dtype=cfg.dtype)
        self.proj = nn.Linear(d, d, dtype=cfg.dtype)

    def forward(self, x, key_lens=None):
        qkv = self.qkv(x)
        out = attention_qkv(qkv, self.num_heads, key_lens=key_lens).to(self.dtype)
        return self.proj(out)


class LayerScale(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.gamma = nn.Parameter(torch.full((dim,), 1e-5))

    def forward(self, x):
        return x * self.gamma.to(x.dtype)


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int, dtype: torch.dtype):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden, dtype=dtype)
        self.fc2 = nn.Linear(hidden, dim, dtype=dtype)
        # bf16: the tanh form (its error sits under bf16 rounding); f32: erf
        self.approximate = "none" if dtype == torch.float32 else "tanh"

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x), approximate=self.approximate))


class Block(nn.Module):
    def __init__(self, cfg: DinoViTConfig):
        super().__init__()
        d = cfg.embed_dim
        self.norm1 = CompatLayerNorm(d, out_dtype=cfg.dtype)
        self.attn = Attention(cfg)
        self.norm2 = CompatLayerNorm(d, out_dtype=cfg.dtype)
        self.mlp = Mlp(d, int(d * cfg.mlp_ratio), cfg.dtype)
        if cfg.layerscale:
            self.ls1 = LayerScale(d)
            self.ls2 = LayerScale(d)
        else:
            self.ls1 = self.ls2 = nn.Identity()

    def forward(self, x, key_lens=None):
        x = x + self.ls1(self.attn(self.norm1(x), key_lens=key_lens))
        return x + self.ls2(self.mlp(self.norm2(x)))


class PatchEmbed(nn.Module):
    """Holds the hub's conv weight (D, 3, P, P) and f32 bias; the forward is a
    matmul on extracted patches (see DinoViT.forward)."""

    def __init__(self, cfg: DinoViTConfig):
        super().__init__()
        p = cfg.patch_size
        self.proj = nn.Conv2d(3, cfg.embed_dim, p, p)


class DinoViT(nn.Module):
    """Frozen DINOv2 backbone. Input (B, H, W, 3) normalised float ->
    pooled patch features (B, 7, 12, embed_dim) f32."""

    def __init__(self, cfg: DinoViTConfig, pool_grid: tuple[int, int] = (7, 12)):
        super().__init__()
        self.cfg = cfg
        self.pool_grid = pool_grid
        d = cfg.embed_dim
        n_prefix = 1 if cfg.use_cls_token else 0
        self.patch_embed = PatchEmbed(cfg)
        if cfg.use_cls_token:
            self.cls_token = nn.Parameter(torch.zeros(1, 1, d))
        self.pos_embed = nn.Parameter(torch.zeros(1, n_prefix + cfg.num_patches, d))
        self.blocks = nn.ModuleList(Block(cfg) for _ in range(cfg.depth))
        self.norm = CompatLayerNorm(d)  # f32 out
        gh, gw = cfg.grid
        ph, pw = pool_grid
        self.register_buffer(
            "pool_h", torch.from_numpy(adaptive_pool_matrix(gh, ph)), persistent=False
        )
        self.register_buffer(
            "pool_w", torch.from_numpy(adaptive_pool_matrix(gw, pw)), persistent=False
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        b = x.shape[0]
        # centre width crop 384 -> 378 (reference dino_preprocessors.py:30)
        excess = x.shape[2] - cfg.img_width
        if excess > 0:
            x = x[:, :, excess // 2 : excess // 2 + cfg.img_width, :]
        x = x.to(cfg.dtype)
        p = cfg.patch_size
        gh, gw = cfg.grid
        d = cfg.embed_dim
        x = x.reshape(b, gh, p, gw, p, 3).permute(0, 1, 3, 2, 4, 5)
        x = x.reshape(b, gh * gw, p * p * 3)
        # hub conv weight (D, 3, P, P) -> the (P*P*3, D) matmul layout
        w = self.patch_embed.proj.weight.permute(2, 3, 1, 0).reshape(p * p * 3, d)
        w = w.to(cfg.dtype)
        # bf16 inputs, f32 accumulation (exact products), f32 bias
        x = (x.float() @ w.float() + self.patch_embed.proj.bias).to(cfg.dtype)

        n_prefix = 1 if cfg.use_cls_token else 0
        if cfg.use_cls_token:
            cls = self.cls_token.to(cfg.dtype).expand(b, 1, d)
            x = torch.cat([cls, x], dim=1)
        x = x + self.pos_embed.to(cfg.dtype)

        # pad the token axis once to a multiple of 16 (433 -> 448); the pad
        # columns are excluded from every softmax through key_lens
        n_tok = x.shape[1]
        pad = -n_tok % 16
        key_lens = None
        if pad:
            x = F.pad(x, (0, 0, 0, pad))
            key_lens = torch.full((b,), n_tok, dtype=torch.int32, device=x.device)
        for blk in self.blocks:
            x = blk(x, key_lens)

        x = self.norm(x)  # f32
        feat = x[:, n_prefix:n_tok, :].reshape(b, gh, gw, d)
        # adaptive average pool (gh, gw) -> pool_grid as two static matmuls
        feat = torch.einsum("og,bgwd->bowd", self.pool_h, feat)
        feat = torch.einsum("ow,bhwd->bhod", self.pool_w, feat)
        return feat  # (B, ph, pw, D)


VIT_CONFIGS = {
    "dinov2_vits14": DinoViTConfig(embed_dim=384, depth=12, num_heads=6),
    "dinov2_vitb14": DinoViTConfig(embed_dim=768, depth=12, num_heads=12),
    "dinov2_vitl14": DinoViTConfig(embed_dim=1024, depth=24, num_heads=16),
    # SigLIP ViT-B/16-256 trunk: patch-only, no layerscale, square input
    "siglip_vitb16_256": DinoViTConfig(
        patch_size=16, embed_dim=768, depth=12, num_heads=12,
        img_height=256, img_width=256, layerscale=False, use_cls_token=False,
    ),
}
