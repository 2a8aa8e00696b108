"""Encoder attention for the port: the packed-qkv CUDA kernel and its plain version.

Counterpart of `safevla_tpu/ops/flash_attention.py`. The ViT blocks and the
first n-1 fusion layers call `attention_qkv` on the raw packed projection
`qkv (B, S, 3*H*Dh)` ([q | k | v] on the last axis) -> `(B, S, H*Dh)`, with
optional per-row valid-key counts `key_lens (B,)` (prefix masks: right-padded
text, padded ViT tokens).

* On a CUDA tensor `attention_qkv` launches `csrc/flash_attention_fwd.cu`
  (the port of the Pallas `_fwd_kernel`) or raises; it never falls back.
* On a CPU tensor it runs `attention_qkv_reference`, the plain PyTorch
  version with the kernel's rounding points: f32 logits scaled by 1/sqrt(Dh),
  -1e30 on masked columns, f32 max/exp/denominator, probabilities cast to the
  IO dtype before the f32-accumulated p.v product, then / denominator.

`dense_attention` is the counterpart of `_xla_attention`: the separate-q/k/v
path the fusion's last layer (one query row) takes, as it does in JAX.
"""

from __future__ import annotations

import ctypes
import math

import torch

_NEG_INF = -1e30
KERNEL_HEAD_DIMS = (64,)  # head dims the CUDA kernel is compiled for
_DTYPE_CODES = {torch.bfloat16: 0, torch.float32: 1}
_C_ARGTYPES = {
    "attention_qkv_fwd": (
        [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # qkv, key_lens, out
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # B, S, H, Dh
            ctypes.c_longlong, ctypes.c_longlong,  # stride_b, stride_s (elements)
            ctypes.c_float, ctypes.c_int, ctypes.c_void_p,  # scale, dtype, stream
        ],
        ctypes.c_int,
    ),
    "attention_qkv_fwd_error_string": ([ctypes.c_int], ctypes.c_char_p),
}


def _split_heads(qkv: torch.Tensor, heads: int):
    b, s, three_lanes = qkv.shape
    lanes = three_lanes // 3
    if three_lanes % 3 or lanes % heads:
        raise ValueError(f"qkv last axis {three_lanes} is not 3 * heads * head_dim")
    return b, s, lanes, lanes // heads


def attention_qkv_reference(
    qkv: torch.Tensor, heads: int, key_lens: torch.Tensor | None = None
) -> torch.Tensor:
    """Plain PyTorch version of the kernel (and of the Pallas `_fwd_kernel`)."""
    b, s, lanes, dh = _split_heads(qkv, heads)
    scale = 1.0 / math.sqrt(dh)
    q, k, v = qkv.reshape(b, s, 3, heads, dh).unbind(2)  # (B, S, H, Dh) each
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if key_lens is not None:
        col = torch.arange(s, device=qkv.device)
        valid = col[None, :] < key_lens.to(qkv.device)[:, None]
        bias = torch.where(valid, 0.0, _NEG_INF)  # (B, S) f32
        logits = logits + bias[:, None, None, :]
    m = logits.amax(dim=-1, keepdim=True)
    e = torch.exp(logits - m)
    denom = e.sum(dim=-1, keepdim=True)  # (B, H, S, 1)
    out = torch.einsum("bhqk,bkhd->bhqd", e.to(qkv.dtype).float(), v.float())
    out = (out / denom).to(qkv.dtype)  # (B, H, S, Dh)
    return out.permute(0, 2, 1, 3).reshape(b, s, lanes)


def attention_qkv(
    qkv: torch.Tensor, heads: int, key_lens: torch.Tensor | None = None
) -> torch.Tensor:
    """Packed-projection attention: qkv (B, S, 3*H*Dh) -> (B, S, H*Dh).

    key_lens (B,) int32 (optional): count of valid keys per row, in [1, S];
    columns >= key_lens[b] are excluded from the softmax. On a CUDA tensor the
    range is checked inside the kernel (a trap), since reading a device
    tensor here would synchronise every call."""
    b, s, lanes, dh = _split_heads(qkv, heads)
    if qkv.device.type == "cpu":
        if key_lens is not None and not bool(((key_lens >= 1) & (key_lens <= s)).all()):
            raise ValueError(f"key_lens must lie in [1, {s}], got {key_lens.tolist()}")
        return attention_qkv_reference(qkv, heads, key_lens)
    if qkv.device.type != "cuda":
        raise ValueError(f"attention_qkv runs on cuda or cpu tensors, not {qkv.device}")
    if qkv.dtype not in _DTYPE_CODES:
        raise ValueError(f"the CUDA kernel takes bfloat16 or float32, not {qkv.dtype}")
    if dh not in KERNEL_HEAD_DIMS:
        raise ValueError(f"the CUDA kernel takes head_dim in {KERNEL_HEAD_DIMS}, not {dh}")
    if not qkv.is_contiguous() or qkv.data_ptr() % 16:
        raise ValueError("the CUDA kernel needs a contiguous, 16-byte aligned qkv")
    if key_lens is not None:
        if (
            key_lens.device != qkv.device
            or key_lens.dtype != torch.int32
            or key_lens.shape != (b,)
            or not key_lens.is_contiguous()
        ):
            raise ValueError(
                f"key_lens must be a contiguous int32 ({b},) tensor on {qkv.device}"
            )
    from safevla_tpu_torch.ops._build import load_library

    lib = load_library("flash_attention_fwd", _C_ARGTYPES)
    out = torch.empty((b, s, lanes), dtype=qkv.dtype, device=qkv.device)
    with torch.cuda.device(qkv.device):
        stream = torch.cuda.current_stream(qkv.device).cuda_stream
        err = lib.attention_qkv_fwd(
            qkv.data_ptr(),
            None if key_lens is None else key_lens.data_ptr(),
            out.data_ptr(),
            b, s, heads, dh,
            qkv.stride(0), qkv.stride(1),
            1.0 / math.sqrt(dh),
            _DTYPE_CODES[qkv.dtype],
            stream,
        )
    if err != 0:
        msg = lib.attention_qkv_fwd_error_string(err).decode()
        raise RuntimeError(f"attention_qkv_fwd launch failed: {msg} (cudaError {err})")
    attention_qkv.launches += 1
    return out


attention_qkv.launches = 0  # kernel launches since the last reset (a plain int)


def dense_attention(q, k, v, key_mask=None):
    """Separate-q/k/v encoder attention, counterpart of JAX `_xla_attention`.

    q (B, Tq, H, D), k/v (B, Tk, H, D), key_mask (B, Tk) bool -> (B, Tq, H, D).
    f32 inputs: f32 logits / sqrt(D), -1e30 on masked keys. Lower precision:
    logits in the input dtype (as XLA's preferred_element_type=dtype), mask
    -1e9, softmax in f32, probabilities cast back before the f32-accumulated
    p.v product."""
    d = q.shape[-1]
    if q.dtype == torch.float32:
        logits = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(d)
        if key_mask is not None:
            logits = torch.where(key_mask[:, None, None, :], logits, _NEG_INF)
        p = torch.softmax(logits, dim=-1)
    else:
        logits = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(d)
        if key_mask is not None:
            fill = torch.tensor(-1e9, dtype=q.dtype, device=q.device)
            logits = torch.where(key_mask[:, None, None, :], logits, fill)
        p = torch.softmax(logits.float(), dim=-1).to(q.dtype)
    out = torch.einsum("bhqk,bkhd->bqhd", p.float(), v.float())
    return out.to(q.dtype)
