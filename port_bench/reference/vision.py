"""Plain PyTorch frozen encoders and image preprocessing, in float32.

* `vit`: a patch-only ViT trunk (SigLIP's vision tower as SPOC cuts it):
  conv patch embedding, learned positions, pre-LN blocks (LayerNorm eps
  1e-6, tanh-approximated GELU as SigLIP's `gelu_pytorch_tanh`), the final
  norm, then an adaptive average pool of the patch grid to the policy's
  (7, 12) grid.
* `text_tower`: open_clip's text transformer as SigLIP uses it (token and
  learned position embeddings, pre-LN blocks with exact GELU, key-masked
  attention, final norm, the output multiplied by the mask); ids past the
  vocabulary take its last row.
* `augment`: the configuration's train-time augmentation from its drawn
  parameters, in SPOC's v2 order: colour jitter (brightness, contrast about
  the image's gray mean, saturation, hue as a YIQ rotation), clamp, a
  separable gaussian blur (9 rows by 5 columns, zero padding), a zoomed
  crop resampled linearly (pixel centres at +0.5, a triangle kernel
  normalised per output, zero outside), posterize over the uint8 grid,
  sharpness against a 3x3 smoothing, clamp.
* `tokenize`: the hash tokenizer the configuration runs without tokenizer
  files (md5 of each lower-cased word into ids 3..vocab-1, EOS 1, PAD 0).
"""

from __future__ import annotations

import hashlib
import math
from typing import Dict, List, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from port_bench.reference.tower import F32, Numerics, attention, heads, layer_norm, merge

Tensor = torch.Tensor


def vit(w: Dict[str, Tensor], v: dict, images: Tensor, nm: Numerics = F32, grid=(7, 12)) -> Tensor:
    """images (N, H, W, 3) normalised -> (N, gh', gw', D) pooled features."""
    p, d, h = v["patch_size"], v["embed_dim"], v["num_heads"]
    x = images.permute(0, 3, 1, 2)
    n, _, hh, ww = x.shape
    gh, gw = hh // p, ww // p
    patches = x.reshape(n, 3, gh, p, gw, p).permute(0, 2, 4, 1, 3, 5).reshape(n, gh * gw, 3 * p * p)
    x = nm.linear(patches, w["patch_embed.proj.weight"].reshape(d, -1), w["patch_embed.proj.bias"])
    x = x + w["pos_embed"]
    for i in range(v["depth"]):
        b = f"blocks.{i}."
        a = layer_norm(x, w[b + "norm1.weight"], w[b + "norm1.bias"], 1e-6)
        q, k, vv = (heads(t, h) for t in nm.linear(a, w[b + "attn.qkv.weight"], w[b + "attn.qkv.bias"]).chunk(3, -1))
        x = x + nm.linear(merge(attention(nm, q, k, vv, None)), w[b + "attn.proj.weight"], w[b + "attn.proj.bias"])
        f = layer_norm(x, w[b + "norm2.weight"], w[b + "norm2.bias"], 1e-6)
        f = F.gelu(nm.linear(f, w[b + "mlp.fc1.weight"], w[b + "mlp.fc1.bias"]), approximate="tanh")
        x = x + nm.linear(f, w[b + "mlp.fc2.weight"], w[b + "mlp.fc2.bias"])
    x = layer_norm(x, w["norm.weight"], w["norm.bias"], 1e-6)
    feat = x.reshape(n, gh, gw, d).permute(0, 3, 1, 2)
    return F.adaptive_avg_pool2d(feat, grid).permute(0, 2, 3, 1)


def text_tower(w: Dict[str, Tensor], t: dict, tokens: Tensor, mask: Tensor, nm: Numerics = F32) -> Tensor:
    """tokens (B, L) int, mask (B, L) bool -> (B, L, D)."""
    h = t["num_heads"]
    ids = tokens.long().clamp(0, t["vocab_size"] - 1)
    x = w["token_embedding.weight"][ids] + w["positional_embedding"][None, : tokens.shape[1]]
    allowed = mask.bool()[:, None, None, :]
    for i in range(t["num_layers"]):
        b = f"transformer.resblocks.{i}."
        a = layer_norm(x, w[b + "ln_1.weight"], w[b + "ln_1.bias"], 1e-6)
        q, k, v = (heads(z, h) for z in nm.linear(a, w[b + "attn.in_proj_weight"], w[b + "attn.in_proj_bias"]).chunk(3, -1))
        x = x + nm.linear(merge(attention(nm, q, k, v, allowed)), w[b + "attn.out_proj.weight"], w[b + "attn.out_proj.bias"])
        f = layer_norm(x, w[b + "ln_2.weight"], w[b + "ln_2.bias"], 1e-6)
        f = F.gelu(nm.linear(f, w[b + "mlp.c_fc.weight"], w[b + "mlp.c_fc.bias"]))
        x = x + nm.linear(f, w[b + "mlp.c_proj.weight"], w[b + "mlp.c_proj.bias"])
    return layer_norm(x, w["ln_final.weight"], w["ln_final.bias"], 1e-6) * mask[..., None]


def tokenize(texts: Sequence[str], max_tokens: int, vocab: int = 32128):
    """-> (tokens (B, L) int32, mask (B, L) bool) as numpy arrays."""
    tokens = np.zeros((len(texts), max_tokens), np.int32)
    mask = np.zeros((len(texts), max_tokens), bool)
    for i, text in enumerate(texts):
        ids = [3 + int(hashlib.md5(word.encode()).hexdigest(), 16) % (vocab - 3) for word in text.lower().split()]
        ids = (ids + [1])[:max_tokens]
        tokens[i, : len(ids)] = ids
        mask[i, : len(ids)] = True
    return tokens, mask


_YIQ = np.asarray([[0.299, 0.587, 0.114], [0.596, -0.274, -0.322], [0.211, -0.523, 0.312]], np.float64)


def _gray(x: Tensor) -> Tensor:
    return (x * torch.tensor([0.299, 0.587, 0.114], device=x.device)).sum(-1, keepdim=True)


def _gauss(size: int, sigma: float, device) -> Tensor:
    i = torch.arange(size, dtype=torch.float32, device=device) - (size - 1) / 2.0
    k = torch.exp(-(i**2) / (2.0 * max(sigma, 1e-6) ** 2))
    return k / k.sum()


def _conv(x: Tensor, k: Tensor) -> Tensor:
    """x (N, H, W, C), k (kh, kw): the same kernel on every channel, zero padding."""
    c = x.shape[-1]
    y = F.conv2d(x.permute(0, 3, 1, 2), k[None, None].expand(c, 1, *k.shape).contiguous(),
                 padding=(k.shape[0] // 2, k.shape[1] // 2), groups=c)
    return y.permute(0, 2, 3, 1)


def _resample(size: int, zoom: float, offset: float, device) -> Tensor:
    """(in, out) weights: output pixel o samples the source at
    (o + 0.5) / zoom + offset - 0.5 with a triangle kernel."""
    src = torch.arange(size, dtype=torch.float64, device=device)
    at = (src + 0.5) / zoom + offset - 0.5  # indexed by the output pixel
    w = torch.clamp(1.0 - (at[None, :] - src[:, None]).abs(), min=0.0)
    tot = w.sum(0, keepdim=True)
    w = torch.where(tot > 1000 * float(np.finfo(np.float32).eps), w / torch.where(tot > 0, tot, 1.0), 0.0)
    inside = (at >= -0.5) & (at <= size - 0.5)
    return torch.where(inside[None, :], w, 0.0).float()


def augment(x: Tensor, a: Dict[str, float]) -> Tensor:
    """x (N, H, W, 3) in [0, 1] -> augmented, same range."""
    dev = x.device
    x = x * a["brightness"]
    mean = _gray(x).mean(dim=(1, 2, 3), keepdim=True)
    x = (x - mean) * a["contrast"] + mean
    g = _gray(x)
    x = (x - g) * a["saturation"] + g
    th = a["hue"] * 2.0 * math.pi
    rot = np.asarray([[1, 0, 0], [0, math.cos(th), -math.sin(th)], [0, math.sin(th), math.cos(th)]])
    m = torch.tensor(np.linalg.inv(_YIQ) @ rot @ _YIQ, dtype=torch.float32, device=dev)
    x = torch.clamp(x @ m.t(), 0.0, 1.0)
    x = _conv(x, _gauss(9, a["blur_sigma"], dev)[:, None])
    x = _conv(x, _gauss(5, a["blur_sigma"], dev)[None, :])
    n, h, w, _ = x.shape
    z = a["crop_zoom"]
    wy = _resample(h, z, a["crop_cy"] * h * (1.0 - 1.0 / z), dev)
    wx = _resample(w, z, a["crop_cx"] * w * (1.0 - 1.0 / z), dev)
    x = torch.einsum("nhwc,ho->nowc", x, wy)
    x = torch.einsum("nowc,wp->nopc", x, wx)
    if a["posterize_bits"] < 8.0:
        step = 2.0 ** (8.0 - a["posterize_bits"])
        x = torch.floor(x * 255.0 / step + 1e-4) * step / 255.0
    smooth = _conv(x, torch.tensor([[1.0, 1, 1], [1, 5, 1], [1, 1, 1]], device=dev) / 13.0)
    x = smooth + a["sharpness"] * (x - smooth)
    return torch.clamp(x, 0.0, 1.0)


def normalise(x: Tensor, means: List[float], stds: List[float]) -> Tensor:
    return (x - torch.tensor(means, device=x.device)) / torch.tensor(stds, device=x.device)
