"""HL-Gauss distributional critic transform.

Copy of `safevla_tpu/ops/hl_gauss.py` on torch tensors (the counterpart of
the reference's torch HLGaussLoss, utils/loss_functions.py:7-30): a scalar
target is smeared into a truncated-Gaussian histogram over fixed bins; the
critic is trained with cross-entropy against that histogram and read out as
the probability-weighted mean of bin centers. Every function computes in
f32. Plain tensor math: the JAX package has no kernel here either.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class HLGauss:
    min_value: float = -5.0
    max_value: float = 15.0
    num_bins: int = 101
    sigma: float = 0.15

    def support(self, device=None) -> torch.Tensor:
        return torch.linspace(
            self.min_value, self.max_value, self.num_bins + 1, dtype=torch.float32, device=device
        )

    def centers(self, device=None) -> torch.Tensor:
        s = self.support(device)
        return (s[:-1] + s[1:]) / 2.0

    def to_probs(self, target: torch.Tensor) -> torch.Tensor:
        """target (...,) -> probs (..., num_bins)."""
        target = target.float()
        cdf = torch.special.erf(
            (self.support(target.device) - target[..., None]) / (math.sqrt(2.0) * self.sigma)
        )
        z = cdf[..., -1] - cdf[..., 0]
        bin_probs = cdf[..., 1:] - cdf[..., :-1]
        return bin_probs / z[..., None]

    def from_probs(self, probs: torch.Tensor) -> torch.Tensor:
        """probs (..., num_bins) -> scalar value (...,)."""
        return (probs.float() * self.centers(probs.device)).sum(dim=-1)

    def from_logits(self, logits: torch.Tensor) -> torch.Tensor:
        return self.from_probs(torch.softmax(logits.float(), dim=-1))

    def loss(self, logits: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        """Mean cross-entropy between logits and the smeared target histogram."""
        logp = torch.log_softmax(logits.float(), dim=-1)
        return -(self.to_probs(target) * logp).sum(dim=-1).mean()
