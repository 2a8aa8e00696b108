"""f32 parameters applied in a lower compute dtype, as flax's `nn.Dense(dtype=...)`.

flax keeps `param_dtype=float32` and casts the input, kernel and bias to
`dtype` at every call; the product and the bias add run in that dtype. The
trainable tower layers of the port do the same, so that an optimizer step of
lr 2e-5 moves an f32 master weight (stored in bf16, a weight of magnitude
~0.05 would round such a step away).

Where no gradient is taken (grad mode off, or a parameter that does not
require grad: serving), the cast copy of a parameter is cached and reused
until the parameter changes. A change shows in its version counter (an
in-place optimizer step, a `load_state_dict`) or its storage (a move to
another device), so an act pays no cast launches and never reads a stale copy.
While a CUDA graph is captured the cache is passed by: the cast is captured
with the graph, so every replay reads the parameter as it is then.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.weak import WeakIdKeyDictionary

# parameter -> (its version key, its cast copy); entries go with the parameter
_CAST_CACHE = WeakIdKeyDictionary()


def cast_param(p: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """`p` in `dtype`: through autograd when a gradient is taken, else from
    the cache (refreshed when `p` has changed since it was filled)."""
    if p.dtype == dtype:
        return p
    if torch.is_grad_enabled() and p.requires_grad:
        return p.to(dtype)
    if p.is_cuda and torch.cuda.is_current_stream_capturing():
        # a CUDA graph casts at every replay: a cached copy, checked here on
        # the host, would go stale after the parameter's next in-place step
        return p.detach().to(dtype)
    key = (dtype, p.device, p.data_ptr(), p._version)
    hit = _CAST_CACHE.get(p)
    if hit is None or hit[0] != key:
        hit = (key, p.detach().to(dtype))
        _CAST_CACHE[p] = hit
    return hit[1]


class Dense(nn.Linear):
    """nn.Linear with f32 parameters, applied in `compute_dtype`: input,
    weight and bias cast to it, product and bias add in it."""

    def __init__(
        self, in_features: int, out_features: int, bias: bool = True,
        compute_dtype: torch.dtype = torch.bfloat16,
    ):
        super().__init__(in_features, out_features, bias=bias)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        bias = None if self.bias is None else cast_param(self.bias, dt)
        return F.linear(x.to(dt), cast_param(self.weight, dt), bias)
