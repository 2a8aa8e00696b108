"""Image normalisation: uint8 -> float, /255, mean/std.

Counterpart of `safevla_tpu/preprocessing/normalize.py` (reference:
dino_preprocessors.py:224-239). The uint8 frames are what crosses to the
device; the arithmetic runs there.
"""

from __future__ import annotations

import torch

from safevla_tpu_torch.constants import DINO_RGB_MEANS, DINO_RGB_STDS


def normalize_images(
    images_u8: torch.Tensor, mean=DINO_RGB_MEANS, std=DINO_RGB_STDS, dtype=torch.float32
) -> torch.Tensor:
    """(..., H, W, 3) uint8 -> normalised float."""
    mean = torch.as_tensor(mean, dtype=dtype, device=images_u8.device)
    std = torch.as_tensor(std, dtype=dtype, device=images_u8.device)
    x = images_u8.to(dtype) / 255.0
    return (x - mean) / std
