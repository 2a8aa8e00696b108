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

On a CUDA tensor the kernels run where JAX's does, a shape rule decided
before any launch (`kernel_takes_dim`): where the JAX `CompatLayerNorm` runs
its plain math (D % 128 != 0, `safevla_tpu/models/norms.py`), `layer_norm`
runs the plain version on the card, differentiated by autograd.

On a CUDA tensor the forward launches `csrc/layer_norm.cu::layer_norm_fwd`
and the backward `::layer_norm_bwd` (one cooperative kernel that also folds
its per-block partial dgamma / dbeta rows, from a workspace allocated here)
or raise; they never fall back. On a CPU tensor both run their plain
versions, `layer_norm_fwd_reference` and `layer_norm_bwd_reference`,
through the same autograd Function. x, the output and g are bfloat16 or
float32; the kernels take every D that is a multiple of 128, as the Pallas
kernels do: up to REGISTER_MAX_DIM the register designs (a row held in the
registers of the lanes that take it), above it the wide designs (a block a
row, the row read again from L1 / L2), `ln_design` deciding before the launch.

The call path is kept short, since a call's host time is longer than its
kernel at every shape of the path: the library's C functions are resolved
once (`_build.bind`), the stream is read as a raw handle, and the C side
makes x's card current only when it is not.
"""

from __future__ import annotations

import ctypes
from types import SimpleNamespace
from typing import Optional, Tuple

import torch

_DTYPE_CODES = {torch.bfloat16: 0, torch.float32: 1}
REGISTER_MAX_DIM = 1024  # the widest row of the register designs (csrc/layer_norm.cu kMaxVecs)
_VOID, _INT, _FLOAT = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_C_ARGTYPES = {
    "layer_norm_fwd": (
        [
            _VOID, _VOID, _VOID, _VOID,  # x, gamma, beta, out
            _INT, _INT, _FLOAT,  # R, D, eps
            _INT, _INT, _INT, _VOID,  # x dtype, out dtype, device, stream
        ],
        _INT,
    ),
    "layer_norm_bwd": (
        [
            _VOID, _VOID, _VOID, _VOID,  # x, gamma, g, dx
            _VOID, _VOID,  # partial rows workspace (blocks, 2D), dparams (2, D)
            _INT, _INT, _INT, _FLOAT,  # R, D, blocks, eps
            _INT, _INT, _INT, _VOID,  # x dtype, g dtype, device, stream
        ],
        _INT,
    ),
    "layer_norm_bwd_max_blocks": ([_INT, _INT, _INT, _INT, _VOID], _INT),  # D, dtypes, device, out
    "layer_norm_error_string": ([_INT], ctypes.c_char_p),
}
BWD_WARPS = 8  # rows a backward block works on at once (csrc/layer_norm.cu kBwdWarps)
_C = None  # the library's C functions, bound at the first launch
_MAX_BLOCKS = {}  # (D, x dtype, g dtype, device) -> blocks of the backward that fit at once


def kernel_takes_dim(d: int) -> bool:
    """JAX's dispatch rule (`safevla_tpu/models/norms.py::CompatLayerNorm`,
    the Pallas kernel's layout precondition): the kernels' function where D
    is a multiple of 128, the plain math elsewhere."""
    return d % 128 == 0


def ln_design(d: int) -> str:
    """The design of csrc/layer_norm.cu that a CUDA call at width D (a
    multiple of 128) launches: "register" up to REGISTER_MAX_DIM, "wide"
    above it."""
    return "register" if d <= REGISTER_MAX_DIM else "wide"


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


def _bind() -> SimpleNamespace:
    global _C
    from safevla_tpu_torch.ops._build import bind

    c = bind("layer_norm", _C_ARGTYPES)
    c.stream = torch._C._cuda_getCurrentRawStream  # device index -> cudaStream_t
    _C = c
    return c


def _f32(p: torch.Tensor) -> torch.Tensor:
    return p if p.dtype is torch.float32 and p.is_contiguous() else p.float().contiguous()


def _check_cuda(x2, xc, d, gamma, dev, what) -> None:
    """What guards the kernel's memory: x's dtype, D, contiguity and 16-byte
    alignment; gamma f32 (D,), aligned, on x's card."""
    if xc is None:
        raise ValueError(f"{what}: the CUDA kernel takes bfloat16 or float32, not {x2.dtype}")
    if d % 128 or d <= 0:
        raise ValueError(f"{what}: the CUDA kernel takes D a multiple of 128, not {d}")
    if not x2.is_contiguous() or x2.data_ptr() % 16:
        raise ValueError(f"{what}: the CUDA kernel needs contiguous, 16-byte aligned rows")
    if gamma.shape != (d,) or gamma.get_device() != dev or gamma.data_ptr() % 16:
        raise ValueError(f"{what}: gamma must be float32 ({d},), 16-byte aligned, on {x2.device}")


def _layer_norm_fwd(x, gamma, beta, eps, out_dtype):
    """The forward over the last axis of any-rank x, in x's shape: kernel on
    CUDA, plain version on the CPU."""
    if not x.is_cuda:
        if x.device.type == "cpu":
            return layer_norm_fwd_reference(x, gamma, beta, eps, out_dtype)
        raise ValueError(f"layer_norm runs on cuda or cpu tensors, not {x.device}")
    c = _C or _bind()
    if not x.is_contiguous():
        x = x.contiguous()
    d = x.shape[-1]
    dev = x.get_device()
    xc, oc = _DTYPE_CODES.get(x.dtype), _DTYPE_CODES.get(out_dtype)
    gamma, beta = _f32(gamma), _f32(beta)
    _check_cuda(x, xc, d, gamma, dev, "layer_norm")
    if oc is None or beta.shape != (d,) or beta.get_device() != dev or beta.data_ptr() % 16:
        raise ValueError(f"layer_norm: out_dtype {out_dtype} / beta {tuple(beta.shape)} not taken")
    out = torch.empty_like(x, dtype=out_dtype)  # x's shape, so no view on either side
    c.layer_norm_fwd(
        x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), out.data_ptr(),
        x.numel() // d, d, eps, xc, oc, dev, c.stream(dev),
    )
    layer_norm.launches += 1
    return out


def bwd_blocks(r: int, max_blocks: int) -> int:
    """Blocks of the backward's grid for R rows: as many as fit on the card
    at once (`max_blocks`), but no more than one per BWD_WARPS rows, so that
    at a few rows every warp still has one. Block b takes rows
    [b * R // blocks, (b + 1) * R // blocks)."""
    return min(max_blocks, -(-r // BWD_WARPS))


def layer_norm_bwd(
    x2: torch.Tensor, gamma: torch.Tensor, g: torch.Tensor, eps: float = 1e-6
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The LayerNorm VJP on (R, D) rows: g -> (dx in x's dtype, dgamma,
    dbeta in f32). On a CUDA tensor it launches the backward kernel (dgamma
    and dbeta included), or raises; on a CPU tensor it runs
    `layer_norm_bwd_reference`."""
    if g.shape != x2.shape:
        raise ValueError(f"g must be {tuple(x2.shape)}, got {tuple(g.shape)}")
    if not x2.is_cuda:
        if x2.device.type == "cpu":
            return layer_norm_bwd_reference(x2, gamma, g, eps)
        raise ValueError(f"layer_norm_bwd runs on cuda or cpu tensors, not {x2.device}")
    c = _C or _bind()
    r, d = x2.shape
    dev = x2.get_device()
    xc, gc = _DTYPE_CODES.get(x2.dtype), _DTYPE_CODES.get(g.dtype)
    gamma = _f32(gamma)
    _check_cuda(x2, xc, d, gamma, dev, "layer_norm_bwd")
    if not g.is_contiguous():
        g = g.contiguous()
    if gc is None or g.get_device() != dev or g.data_ptr() % 16:
        raise ValueError("layer_norm_bwd: g must be bfloat16 or float32, 16-byte aligned, on x's device")
    key = (d, xc, gc, dev)
    most = _MAX_BLOCKS.get(key)
    if most is None:
        n = ctypes.c_int(0)
        c.layer_norm_bwd_max_blocks(d, xc, gc, dev, ctypes.byref(n))
        most = _MAX_BLOCKS[key] = n.value
    blocks = bwd_blocks(r, most)
    dx = torch.empty_like(x2)
    # one allocation: the blocks' partial rows, then [dgamma; dbeta]
    part = x2.new_empty((blocks + 1, 2, d), dtype=torch.float32)
    ptr = part.data_ptr()
    c.layer_norm_bwd(
        x2.data_ptr(), gamma.data_ptr(), g.data_ptr(), dx.data_ptr(), ptr, ptr + blocks * 8 * d,
        r, d, blocks, eps, xc, gc, dev, c.stream(dev),
    )
    layer_norm_bwd.launches += 1
    dgamma, dbeta = part[blocks].unbind()
    return dx, dgamma, dbeta


# kernel launches since the last reset (a plain int); a CUDA graph of the
# fusion pass counts its launches at each replay (models/fusion_pass.py)
layer_norm_bwd.launches = 0


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


def layer_norm_rows(
    x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor, eps: float = 1e-6,
    out_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """The kernels' (R, D) entry, JAX's `layer_norm_rows`: x two-dimensional
    with D a multiple of 128 (else ValueError, as the Pallas kernels'
    geometry raises); the rest is `layer_norm`, its VJP included."""
    if x.dim() != 2 or not kernel_takes_dim(x.shape[-1]):
        raise ValueError(f"layer_norm_rows takes (R, D) rows with D a multiple of 128, not {tuple(x.shape)}")
    return layer_norm(x, gamma, beta, eps, out_dtype)


def layer_norm(
    x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor, eps: float = 1e-6,
    out_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """LayerNorm over the last axis of any-rank x, its leading axes
    flattened into rows; gamma / beta (D,) f32; output in `out_dtype`
    (x's dtype when None). Differentiable in x, gamma and beta: when a
    gradient is taken, the backward is `layer_norm_bwd`. On a CUDA tensor
    where `kernel_takes_dim` is False: the plain version, by autograd."""
    out_dtype = out_dtype or x.dtype
    if x.is_cuda and not kernel_takes_dim(x.shape[-1]):
        return layer_norm_fwd_reference(x, gamma, beta, eps, out_dtype)
    if torch.is_grad_enabled() and (x.requires_grad or gamma.requires_grad or beta.requires_grad):
        shape = x.shape
        x2 = x.reshape(-1, shape[-1]).contiguous()
        return _LayerNorm.apply(x2, gamma, beta, eps, out_dtype).reshape(shape)
    return _layer_norm_fwd(x, gamma, beta, eps, out_dtype)


# kernel launches since the last reset (a plain int); a CUDA graph of the
# fusion pass counts its launches at each replay (models/fusion_pass.py)
layer_norm.launches = 0
