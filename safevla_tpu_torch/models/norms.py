"""Norm modules shared by the encoder stacks.

Counterpart of `safevla_tpu/models/norms.py::CompatLayerNorm`: LayerNorm with
f32 statistics and parameters, flax's fast variance max(0, E[x^2] - E[x]^2),
eps 1e-6 (torch's nn.LayerNorm default is 1e-5), output cast to `out_dtype`
(f32 when None). Parameters are named `weight` / `bias` after torch's
nn.LayerNorm, so reference state dicts load by name.

CompatLayerNorm runs `ops.layer_norm.layer_norm`: on a CUDA tensor the row
LayerNorm kernels (the port of the Pallas LayerNorm; rows wider than 1024
take their wide designs) where D is a multiple of 128, the JAX module's own condition for its
kernel, and the plain version at any other D, as the JAX module runs its
plain math there; on a CPU tensor the plain version. The JAX package takes its kernel only under `SAFEVLA_PALLAS_LN=1`,
for XLA's layout assignment around the custom call; eager PyTorch has no such
cost, so the port has no such switch. CompatLayerNorm sits where the JAX
package's does: the ViT's norm1, norm2 and final norm, and the fusion
layers' norm1 and norm2. The towers' adapter norms are flax `nn.LayerNorm` in
the JAX package, which never reaches the kernel: here they are
`PlainLayerNorm`, the same math as plain PyTorch on every device.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from safevla_tpu_torch.ops.layer_norm import layer_norm, layer_norm_fwd_reference


class CompatLayerNorm(nn.Module):
    def __init__(self, dim: int, eps: float = 1e-6, out_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.eps = eps
        self.out_dtype = out_dtype or torch.float32
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def plain(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm_fwd_reference(x, self.weight, self.bias, self.eps, self.out_dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm(x, self.weight, self.bias, self.eps, self.out_dtype)


class PlainLayerNorm(CompatLayerNorm):
    """flax `nn.LayerNorm(dtype=f32)`: CompatLayerNorm's math, never routed
    to the kernel (the towers' adapter norms)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.plain(x)
