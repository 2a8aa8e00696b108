"""Norm modules shared by the encoder stacks.

Counterpart of `safevla_tpu/models/norms.py::CompatLayerNorm`: LayerNorm with
f32 statistics and parameters, flax's fast variance max(0, E[x^2] - E[x]^2),
eps 1e-6 (torch's nn.LayerNorm default is 1e-5), output cast to `out_dtype`
(f32 when None). Parameters are named `weight` / `bias` after torch's
nn.LayerNorm, so reference state dicts load by name. The JAX package's Pallas
LayerNorm is off by default (SAFEVLA_PALLAS_LN=0) and is not ported yet.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn


class CompatLayerNorm(nn.Module):
    def __init__(self, dim: int, eps: float = 1e-6, out_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.eps = eps
        self.out_dtype = out_dtype or torch.float32
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        mu = xf.mean(dim=-1, keepdim=True)
        mu2 = (xf * xf).mean(dim=-1, keepdim=True)
        var = torch.clamp(mu2 - mu * mu, min=0.0)
        y = (xf - mu) * (torch.rsqrt(var + self.eps) * self.weight) + self.bias
        return y.to(self.out_dtype)
