"""Deterministic, seedable data augmentation on the device.

Counterpart of `safevla_tpu/preprocessing/augment.py`. The reference samples
a torchvision transform pipeline once every `max_steps` steps
(dino_preprocessors.py:224-231, transformation_util.py:12-48); here, as in
the JAX package, one concrete transform is a small struct of scalars sampled
on the host (from a `torch.Generator`) and applied as fixed-shape tensor math:
jitter -> gaussian blur -> crop-resize -> posterize -> sharpness
(-> grayscale, v1).

The blur and the crop-resize run in f32. The JAX package runs them in bf16 by
default (SAFEVLA_AUGMENT_F32=1 selects f32 there); the uint8 sources carry 8
significant bits either way. `_crop_resize` reproduces
`jax.image.scale_and_translate(method="linear")` with two 1-D weight
matrices built as JAX builds them (pixel centres at +0.5, triangle kernel,
per-output normalisation, zero outside the source) applied as matmuls.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F


class AugmentParams(NamedTuple):
    brightness: float  # multiplicative factor
    contrast: float
    saturation: float
    hue: float  # additive shift in [-0.05, 0.05] (fraction of the hue circle)
    enabled: float  # 0/1 gate
    blur_sigma: float  # gaussian blur sigma; always on when enabled
    crop_zoom: float  # RandomResizedCrop zoom factor >= 1 (1 = no crop)
    crop_cx: float  # crop offset fractions in [0, 1]
    crop_cy: float
    posterize_bits: float  # effective bit depth; 8 = no-op
    sharpness: float  # blend factor; 1 = no-op
    grayscale: float  # 0/1 (v1 only)


def sample_augment_params(
    generator: torch.Generator,
    brightness: float = 0.4,
    contrast: float = 0.4,
    saturation: float = 0.2,
    hue: float = 0.05,
    version: str = "v2",
) -> AugmentParams:
    """One concrete transform, as the reference's `sample_a_specific_transform`:
    jitter factors uniform in torchvision's ranges, blur sigma U(0.1, 2), crop
    area U(0.9, 1), posterize gates, sharpness / grayscale coin flips."""
    if version == "v1":
        saturation, hue = 0.4, 0.2
    elif version != "v2":
        raise NotImplementedError(f"augmentation versions are v1/v2, got {version}")

    def rand(n=()):
        return torch.rand(n, generator=generator, dtype=torch.float32)

    def u(lo, hi):
        return float(lo + (hi - lo) * rand())

    jitter = lambda v: u(max(0.0, 1 - v), 1 + v)
    b, c, s = jitter(brightness), jitter(contrast), jitter(saturation)
    h = u(-hue, hue)
    area = u(0.9, 1.0)
    if version == "v2":
        # four independent Posterize(bits, p=0.2); the fewest bits applied wins
        gates = rand((4,)) < 0.2
        bits = min([8.0] + [o for o, g in zip((7.0, 6.0, 5.0, 4.0), gates.tolist()) if g])
        sharpness = 2.0 if float(rand()) < 0.5 else 1.0
        grayscale = 0.0
    else:
        bits = 7.0 if float(rand()) < 0.3 else 8.0
        sharpness = 2.0
        grayscale = 1.0 if float(rand()) < 0.2 else 0.0
    return AugmentParams(
        brightness=b,
        contrast=c,
        saturation=s,
        hue=h,
        enabled=1.0,
        blur_sigma=u(0.1, 2.0),
        crop_zoom=float(1.0 / np.sqrt(np.float32(area))),
        crop_cx=u(0.0, 1.0),
        crop_cy=u(0.0, 1.0),
        posterize_bits=bits,
        sharpness=sharpness,
        grayscale=grayscale,
    )


def identity_augment_params() -> AugmentParams:
    return AugmentParams(
        brightness=1.0, contrast=1.0, saturation=1.0, hue=0.0, enabled=0.0,
        blur_sigma=0.0, crop_zoom=1.0, crop_cx=0.5, crop_cy=0.5,
        posterize_bits=8.0, sharpness=1.0, grayscale=0.0,
    )


def _rgb_to_grayscale(x):
    return 0.299 * x[..., 0:1] + 0.587 * x[..., 1:2] + 0.114 * x[..., 2:3]


_RGB2YIQ = np.asarray(
    [[0.299, 0.587, 0.114], [0.596, -0.274, -0.322], [0.211, -0.523, 0.312]],
    dtype=np.float64,
)
# inverse taken in float64, so a zero hue rotation is a true identity
_YIQ2RGB = np.linalg.inv(_RGB2YIQ)

_SHARPNESS_KERNEL = np.asarray(
    [[1.0, 1.0, 1.0], [1.0, 5.0, 1.0], [1.0, 1.0, 1.0]], dtype=np.float32
) / 13.0


def _f32(v, device) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.float32, device=device)


def _gaussian_kernel(size: int, sigma: torch.Tensor) -> torch.Tensor:
    i = torch.arange(size, dtype=torch.float32, device=sigma.device) - (size - 1) / 2.0
    w = torch.exp(-(i**2) / (2.0 * torch.clamp(sigma, min=1e-6) ** 2))
    return w / w.sum()


def _depthwise(x, kernel_hw: torch.Tensor, padding) -> torch.Tensor:
    """x (N, H, W, C) -> same, zero-padded depthwise conv with one (kh, kw)
    kernel for every channel."""
    c = x.shape[-1]
    k = kernel_hw[None, None].expand(c, 1, *kernel_hw.shape)
    y = F.conv2d(x.permute(0, 3, 1, 2), k, padding=padding, groups=c)
    return y.permute(0, 2, 3, 1)


def _separable_blur(x, sigma, kh: int = 9, kw: int = 5):
    """Depthwise gaussian blur, torchvision kernel_size=(5, 9) semantics:
    a vertical (9, 1) pass then a horizontal (1, 5) pass."""
    sig = _f32(sigma, x.device)
    y = _depthwise(x, _gaussian_kernel(kh, sig)[:, None], (kh // 2, 0))
    return _depthwise(y, _gaussian_kernel(kw, sig)[None, :], (0, kw // 2))


def _smooth3x3(x):
    k = torch.from_numpy(_SHARPNESS_KERNEL).to(x.device)
    return _depthwise(x, k, (1, 1))


def linear_resample_matrix(in_size: int, scale, translation) -> torch.Tensor:
    """(in_size, out_size = in_size) weights of JAX's `compute_weight_mat` for
    the triangle kernel with scale >= 1 (antialias has no effect there)."""
    inv_scale = 1.0 / scale
    out = torch.arange(in_size, dtype=torch.float32, device=scale.device)
    sample_f = (out + 0.5) * inv_scale - translation * inv_scale - 0.5
    src = torch.arange(in_size, dtype=torch.float32, device=scale.device)
    w = torch.clamp(1.0 - torch.abs(sample_f[None, :] - src[:, None]), min=0.0)
    total = w.sum(dim=0, keepdim=True)
    w = torch.where(
        torch.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
        w / torch.where(total != 0, total, 1.0),
        0.0,
    )
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return torch.where(inside[None, :], w, 0.0)


def _crop_resize(x, zoom, cx, cy):
    """RandomResizedCrop as scale-and-translate: zoom >= 1 magnifies a window
    whose top-left is chosen by (cx, cy) within the slack (aspect kept)."""
    n, h, w, c = x.shape
    zoom = _f32(zoom, x.device)
    ty = -zoom * (_f32(cy, x.device) * (h * (1.0 - 1.0 / zoom)))
    tx = -zoom * (_f32(cx, x.device) * (w * (1.0 - 1.0 / zoom)))
    wy = linear_resample_matrix(h, zoom, ty)  # (H_in, H_out)
    wx = linear_resample_matrix(w, zoom, tx)  # (W_in, W_out)
    y = torch.einsum("nhwc,ho->nowc", x, wy)
    return torch.einsum("nowc,wp->nopc", y, wx)


def apply_augment(images: torch.Tensor, p: AugmentParams) -> torch.Tensor:
    """images (..., H, W, 3) f32 in [0, 1] -> augmented, same range.

    Order as the reference v2 list (transformation_util.py:14-28): jitter ->
    blur -> crop-resize -> posterize -> sharpness (-> grayscale, v1)."""
    if p.enabled <= 0:
        return images
    lead = images.shape[:-3]
    x = images.reshape((-1,) + images.shape[-3:]).float()
    dev = x.device

    # colour jitter: brightness, contrast about the per-image gray mean,
    # saturation (blend with gray), hue as a YIQ rotation
    x = x * _f32(p.brightness, dev)
    mean = _rgb_to_grayscale(x).mean(dim=(-3, -2, -1), keepdim=True)
    x = (x - mean) * _f32(p.contrast, dev) + mean
    gray = _rgb_to_grayscale(x)
    x = (x - gray) * _f32(p.saturation, dev) + gray
    theta = _f32(p.hue, dev) * 2.0 * math.pi
    cos_h, sin_h = torch.cos(theta), torch.sin(theta)
    yiq = torch.einsum("...c,dc->...d", x, torch.from_numpy(_RGB2YIQ.astype(np.float32)).to(dev))
    y, i, q = yiq[..., 0], yiq[..., 1], yiq[..., 2]
    i, q = i * cos_h - q * sin_h, i * sin_h + q * cos_h
    x = torch.einsum(
        "...c,dc->...d",
        torch.stack([y, i, q], dim=-1),
        torch.from_numpy(_YIQ2RGB.astype(np.float32)).to(dev),
    )
    x = torch.clamp(x, 0.0, 1.0)

    x = _separable_blur(x, p.blur_sigma)
    x = _crop_resize(x, p.crop_zoom, p.crop_cx, p.crop_cy)
    if p.posterize_bits < 8.0:
        # quantise to 2^bits levels over the uint8 grid (the epsilon keeps
        # exact uint8 multiples from rounding down a whole level)
        step = 2.0 ** (8.0 - p.posterize_bits)
        x = torch.floor(x * 255.0 / step + 1e-4) * step / 255.0
    smooth = _smooth3x3(x)
    x = smooth + _f32(p.sharpness, dev) * (x - smooth)
    if p.grayscale > 0:
        x = _rgb_to_grayscale(x).expand(x.shape)
    x = torch.clamp(x, 0.0, 1.0)
    return x.reshape(lead + images.shape[-3:])
