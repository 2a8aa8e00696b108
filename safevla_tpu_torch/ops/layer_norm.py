"""Row LayerNorm for the port: the CUDA kernels and their plain versions.

Counterpart of `safevla_tpu/ops/layer_norm.py` (the Pallas `_ln_fwd_kernel`
and `_ln_bwd_kernel`). `layer_norm(x, gamma, beta, eps, out_dtype)`
normalises the last axis of x, its leading axes flattened into (R, D) rows:

* statistics in f32 with the fast variance, mu = mean(x), var = max(0,
  mean(x*x) - mu^2), rs = rsqrt(var + eps); the output
  (x - mu) * (rs * gamma) + beta in f32, rounded once to `out_dtype`;
* its gradient recomputes the statistics from x (the residual is (x, gamma)
  alone, as the JAX VJP's): dx = rs * (gh - mean(gh) - xhat * mean(gh*xhat))
  with gh = g * gamma and g cast to f32 first, rounded to x's dtype;
  dgamma = sum g * xhat and dbeta = sum g over the rows, in f32.

On a CUDA tensor the forward launches `csrc/layer_norm.cu::layer_norm_fwd`
and the backward `::layer_norm_bwd` (which writes one partial dgamma / dbeta
row per block; the sum of those rows happens here) or raise; they never fall
back. On a CPU tensor both run their plain versions,
`layer_norm_fwd_reference` and `layer_norm_bwd_reference`, through the same
autograd Function. x, the output and g are bfloat16 or float32; D is a
multiple of 128 up to 1024.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

_DTYPE_CODES = {torch.bfloat16: 0, torch.float32: 1}
MAX_DIM = 1024
_C_ARGTYPES = {
    "layer_norm_fwd": (
        [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # x, gamma, beta, out
            ctypes.c_int, ctypes.c_int, ctypes.c_float,  # R, D, eps
            ctypes.c_int, ctypes.c_int, ctypes.c_void_p,  # x dtype, out dtype, stream
        ],
        ctypes.c_int,
    ),
    "layer_norm_fwd_error_string": ([ctypes.c_int], ctypes.c_char_p),
    "layer_norm_bwd": (
        [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # x, gamma, g, dx
            ctypes.c_void_p, ctypes.c_void_p,  # dgamma / dbeta partial rows
            ctypes.c_int, ctypes.c_int, ctypes.c_float,  # R, D, eps
            ctypes.c_int, ctypes.c_int, ctypes.c_void_p,  # x dtype, g dtype, stream
        ],
        ctypes.c_int,
    ),
    "layer_norm_bwd_error_string": ([ctypes.c_int], ctypes.c_char_p),
    "layer_norm_bwd_partial_rows": ([ctypes.c_int], ctypes.c_int),
}


def _stats(xf: torch.Tensor, eps: float) -> Tuple[torch.Tensor, torch.Tensor]:
    mu = xf.mean(dim=-1, keepdim=True)
    mu2 = (xf * xf).mean(dim=-1, keepdim=True)
    var = torch.clamp(mu2 - mu * mu, min=0.0)
    return mu, torch.rsqrt(var + eps)


def layer_norm_fwd_reference(
    x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor, eps: float = 1e-6,
    out_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """Plain PyTorch version of the forward kernel (and of `_ln_fwd_kernel`)."""
    xf = x.float()
    mu, rs = _stats(xf, eps)
    y = (xf - mu) * (rs * gamma.float()) + beta.float()
    return y.to(out_dtype or x.dtype)


def layer_norm_bwd_reference(
    x: torch.Tensor, gamma: torch.Tensor, g: torch.Tensor, eps: float = 1e-6
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the backward kernel (and of `_ln_bwd_kernel`
    plus its wrapper's partial sums): x, g (R, D) -> (dx in x's dtype,
    dgamma, dbeta in f32)."""
    xf, gf = x.float(), g.float()
    mu, rs = _stats(xf, eps)
    xhat = (xf - mu) * rs
    gh = gf * gamma.float()
    m1 = gh.mean(dim=-1, keepdim=True)
    m2 = (gh * xhat).mean(dim=-1, keepdim=True)
    dx = (rs * (gh - m1 - xhat * m2)).to(x.dtype)
    return dx, (gf * xhat).sum(dim=0), gf.sum(dim=0)


def _check_cuda(x: torch.Tensor, gamma: torch.Tensor, what: str) -> Tuple[int, int]:
    r, d = x.shape
    if x.dtype not in _DTYPE_CODES:
        raise ValueError(f"{what}: the CUDA kernel takes bfloat16 or float32, not {x.dtype}")
    if d % 128 or d > MAX_DIM:
        raise ValueError(f"{what}: the CUDA kernel takes D a multiple of 128 up to {MAX_DIM}, not {d}")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError(f"{what}: the CUDA kernel needs contiguous, 16-byte aligned rows")
    if gamma.shape != (d,) or gamma.dtype != torch.float32 or gamma.device != x.device:
        raise ValueError(f"{what}: gamma must be float32 ({d},) on {x.device}")
    return r, d


def _params_f32(*ps: torch.Tensor):
    return [p.float().contiguous() for p in ps]


def _layer_norm_fwd(x2, gamma, beta, eps, out_dtype):
    """The forward on (R, D) rows: kernel on CUDA, plain version on the CPU."""
    if x2.device.type == "cpu":
        return layer_norm_fwd_reference(x2, gamma, beta, eps, out_dtype)
    if x2.device.type != "cuda":
        raise ValueError(f"layer_norm runs on cuda or cpu tensors, not {x2.device}")
    gamma, beta = _params_f32(gamma, beta)
    r, d = _check_cuda(x2, gamma, "layer_norm")
    if out_dtype not in _DTYPE_CODES or beta.shape != (d,) or beta.device != x2.device:
        raise ValueError(f"layer_norm: out_dtype {out_dtype} / beta {tuple(beta.shape)} not taken")
    from safevla_tpu_torch.ops._build import launch, load_library

    lib = load_library("layer_norm", _C_ARGTYPES)
    out = torch.empty((r, d), dtype=out_dtype, device=x2.device)
    with torch.cuda.device(x2.device):
        launch(
            lib, "layer_norm_fwd",
            x2.data_ptr(), gamma.data_ptr(), beta.data_ptr(), out.data_ptr(),
            r, d, eps, _DTYPE_CODES[x2.dtype], _DTYPE_CODES[out_dtype],
            torch.cuda.current_stream(x2.device).cuda_stream,
        )
    layer_norm.launches += 1
    return out


def layer_norm_bwd(
    x2: torch.Tensor, gamma: torch.Tensor, g: torch.Tensor, eps: float = 1e-6
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The LayerNorm VJP on (R, D) rows: g -> (dx in x's dtype, dgamma,
    dbeta in f32). On a CUDA tensor it launches the backward kernel and sums
    its per-block partial rows, or raises; on a CPU tensor it runs
    `layer_norm_bwd_reference`."""
    if g.shape != x2.shape:
        raise ValueError(f"g must be {tuple(x2.shape)}, got {tuple(g.shape)}")
    if x2.device.type == "cpu":
        return layer_norm_bwd_reference(x2, gamma, g, eps)
    if x2.device.type != "cuda":
        raise ValueError(f"layer_norm_bwd runs on cuda or cpu tensors, not {x2.device}")
    (gamma,) = _params_f32(gamma)
    r, d = _check_cuda(x2, gamma, "layer_norm_bwd")
    g = g.contiguous()
    if g.dtype not in _DTYPE_CODES or g.device != x2.device or g.data_ptr() % 16:
        raise ValueError("layer_norm_bwd: g must be bfloat16 or float32, 16-byte aligned, on x's device")
    from safevla_tpu_torch.ops._build import launch, load_library

    lib = load_library("layer_norm", _C_ARGTYPES)
    dx = torch.empty_like(x2)
    parts = torch.empty((2, lib.layer_norm_bwd_partial_rows(r), d), dtype=torch.float32, device=x2.device)
    with torch.cuda.device(x2.device):
        launch(
            lib, "layer_norm_bwd",
            x2.data_ptr(), gamma.data_ptr(), g.data_ptr(), dx.data_ptr(),
            parts[0].data_ptr(), parts[1].data_ptr(),
            r, d, eps, _DTYPE_CODES[x2.dtype], _DTYPE_CODES[g.dtype],
            torch.cuda.current_stream(x2.device).cuda_stream,
        )
    layer_norm_bwd.launches += 1
    dgamma, dbeta = parts.sum(dim=1)
    return dx, dgamma, dbeta


layer_norm_bwd.launches = 0  # kernel launches since the last reset (a plain int)


class _LayerNorm(torch.autograd.Function):
    """Row LayerNorm with the recomputing VJP as its backward. Under
    torch.utils.checkpoint the forward runs again in the backward pass, and
    the saved x is the recomputed one."""

    @staticmethod
    def forward(ctx, x2, gamma, beta, eps, out_dtype):
        ctx.eps = eps
        ctx.save_for_backward(x2, gamma)
        return _layer_norm_fwd(x2, gamma, beta, eps, out_dtype)

    @staticmethod
    def backward(ctx, g):
        x2, gamma = ctx.saved_tensors
        dx, dgamma, dbeta = layer_norm_bwd(x2, gamma, g, ctx.eps)
        return dx, dgamma.to(gamma.dtype), dbeta.to(gamma.dtype), None, None


def layer_norm(
    x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor, eps: float = 1e-6,
    out_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """LayerNorm over the last axis of any-rank x, its leading axes
    flattened into rows; gamma / beta (D,) f32; output in `out_dtype`
    (x's dtype when None). Differentiable in x, gamma and beta: when a
    gradient is taken, the backward is `layer_norm_bwd`."""
    shape = x.shape
    x2 = x.reshape(-1, shape[-1]).contiguous()
    out_dtype = out_dtype or x.dtype
    if torch.is_grad_enabled() and (x.requires_grad or gamma.requires_grad or beta.requires_grad):
        y = _LayerNorm.apply(x2, gamma, beta, eps, out_dtype)
    else:
        y = _layer_norm_fwd(x2, gamma, beta, eps, out_dtype)
    return y.reshape(shape)


layer_norm.launches = 0  # kernel launches since the last reset (a plain int)
