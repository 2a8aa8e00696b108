"""Encoder attention for the port: the packed-qkv CUDA kernel and its plain version.

Counterpart of `safevla_tpu/ops/flash_attention.py`. The ViT blocks and the
first n-1 fusion layers call `attention_qkv` on the raw packed projection
`qkv (B, S, 3*H*Dh)` ([q | k | v] on the last axis) -> `(B, S, H*Dh)`, with
optional per-row valid-key counts `key_lens (B,)` (prefix masks: right-padded
text, padded ViT tokens).

* On a CUDA tensor the kernel runs where JAX's does, a shape rule decided
  before any launch (`kernel_takes`): where the JAX package takes XLA
  (`lanes % 128 != 0 or lanes % heads != 0`,
  `safevla_tpu/ops/flash_attention.py::attention_qkv`), q/k/v are folded and
  `dense_attention` runs on the card, with the key mask built from
  `key_lens`.
* On a CUDA tensor `attention_qkv` launches `csrc/flash_attention_fwd.cu`
  (the port of the Pallas `_fwd_kernel`) or raises; it never falls back.
  `attention_design` picks the design before any launch: the resident
  designs at head dims `KERNEL_HEAD_DIMS` up to their largest S
  (`resident_max_s`), the same source's streaming design at any other S and
  at every other head dim up to 256, and above 256 the sliced streaming
  design (the head staged `SLICE_HEAD_DIM` columns at a time): every head
  dim JAX's kernel takes. A launch takes at most 65535 batch rows and heads
  (grid.z, grid.y); `launch_slices` splits a larger call into several.
* On a CPU tensor it runs `attention_qkv_reference`, the plain PyTorch
  version with the kernel's rounding points: f32 logits scaled by 1/sqrt(Dh),
  -1e30 on masked columns, f32 max/exp/denominator, probabilities cast to the
  IO dtype before the f32-accumulated p.v product, then / denominator.
* Whenever a gradient is taken, `attention_qkv` goes through
  `_AttentionQKV`, an autograd Function (the custom VJP of JAX's
  `_attention_diff_qkv`). It saves (qkv, key_lens) as the JAX residual does;
  its backward is `attention_qkv_bwd`: on a CUDA tensor
  `csrc/flash_attention_bwd.cu` (the port of the Pallas `_bwd_kernel`), on a
  CPU tensor `attention_qkv_bwd_reference`, whose rounding points are the
  TPU kernel's: p = io(e / rowsum(e)) (division BEFORE the cast, unlike the
  forward), ds = p * (dp - rowsum(dp * p)) in f32, io(ds) for dq and dk.

`dense_attention` is the counterpart of `_xla_attention`: the separate-q/k/v
path the fusion's last layer (one query row) takes, as it does in JAX.
`flash_attention` (q, k, v packed into one qkv for `attention_qkv`) and
`attention` (the dispatcher between it and `dense_attention`) are the JAX
package's separate-q/k/v entries, on the same kernels.
"""

from __future__ import annotations

import ctypes
import math

import torch

_NEG_INF = -1e30
KERNEL_HEAD_DIMS = (16, 32, 64, 128)  # head dims the resident designs are compiled for
STREAM_HEAD_DIMS = (16, 32, 64, 128, 256)  # padded head dims of the streaming designs
SLICE_HEAD_DIM = STREAM_HEAD_DIMS[-1]  # columns of a head slice of the sliced design (above it)
SMEM_PER_BLOCK = 232448  # bytes of shared memory a block may use on an H100 (227 KB)
MAX_GRID_YZ = 65535  # blocks a launch may have along grid.y (heads) and grid.z (batch rows)
STREAM_BLOCK_ROWS, STREAM_TILE_ROWS = 64, 32  # csrc/attention_stream.cuh kBlockRows, kTileRows
_DTYPE_CODES = {torch.bfloat16: 0, torch.float32: 1}
_FWD_ARGS = [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # qkv, key_lens, out (at the launch's row 0)
    ctypes.c_int, ctypes.c_int, ctypes.c_int,  # B (of the launch), S, H (of qkv)
    ctypes.c_int, ctypes.c_int, ctypes.c_int,  # h0, heads of the launch, Dh
    ctypes.c_longlong, ctypes.c_longlong,  # stride_b, stride_s (elements)
    ctypes.c_float, ctypes.c_int,  # scale, dtype
]
_C_ARGTYPES = {
    "attention_qkv_fwd": (_FWD_ARGS + [ctypes.c_void_p], ctypes.c_int),  # stream
    # the streaming design takes the bytes of its row copies before the stream
    "attention_qkv_fwd_stream": (_FWD_ARGS + [ctypes.c_int, ctypes.c_void_p], ctypes.c_int),
    "attention_qkv_fwd_error_string": ([ctypes.c_int], ctypes.c_char_p),
}
_BWD_PTRS = [ctypes.c_void_p] * 4  # qkv, g, key_lens, dqkv
_BWD_REST = [
    ctypes.c_int, ctypes.c_int, ctypes.c_int,  # B (of the launch), S, H (of qkv)
    ctypes.c_int, ctypes.c_int, ctypes.c_int,  # h0, heads of the launch, Dh
    ctypes.c_longlong, ctypes.c_longlong,  # qkv / dqkv stride_b, stride_s (elements)
    ctypes.c_float, ctypes.c_int,  # scale, dtype
]
_C_ARGTYPES_BWD = {
    "attention_qkv_bwd": (_BWD_PTRS + _BWD_REST + [ctypes.c_void_p], ctypes.c_int),
    # the streaming designs take an f32 (3, B, heads, S) scratch after dqkv, and
    # the bytes of its row copies before the stream
    "attention_qkv_bwd_stream": (
        _BWD_PTRS + [ctypes.c_void_p] + _BWD_REST + [ctypes.c_int, ctypes.c_void_p], ctypes.c_int
    ),
    "attention_qkv_bwd_error_string": ([ctypes.c_int], ctypes.c_char_p),
}


def kernel_takes(lanes: int, heads: int) -> bool:
    """JAX's dispatch rule (`safevla_tpu/ops/flash_attention.py::
    attention_qkv`, with no key_mask): the kernel's function where the
    Pallas kernel runs, `dense_attention` (its `_xla_attention`) elsewhere."""
    return lanes % 128 == 0 and lanes % heads == 0


def resident_max_s(kind: str, dtype: torch.dtype, dh: int) -> int:
    """The largest S the resident design of `kind` ("fwd" or "bwd") takes
    at this dtype and head dim: the shared memory a block of it needs fits
    in SMEM_PER_BLOCK (the formulas of csrc/flash_attention_{fwd,bwd}.cu).
    Above it the wrapper launches the streaming design."""
    if kind == "fwd":
        if dtype == torch.bfloat16:  # (2 + ceil(S / 64)) tiles of 64 rows
            return 64 * (SMEM_PER_BLOCK // (64 * dh * 2) - 2)
        return SMEM_PER_BLOCK // ((dh + 1) * 4 + 16 * 4)  # K rows and 16 warps' logits
    if dtype == torch.bfloat16:  # 4 planes and 3 f32 statistics a row, rows in 16s
        return 16 * (SMEM_PER_BLOCK // (16 * (4 * dh * 2 + 3 * 4)))
    return SMEM_PER_BLOCK // (3 * (dh + 1) * 4 + (2 * 16 + 3) * 4)


def padded_head_dim(dh: int) -> int:
    """The streaming designs' template for head dim `dh`: the least of
    STREAM_HEAD_DIMS not below it (the pad columns are zeros)."""
    for dp in STREAM_HEAD_DIMS:
        if dh <= dp:
            return dp
    raise ValueError(f"no streaming template takes head dim {dh}")


def copy_width(dh: int, itemsize: int) -> int:
    """Bytes a copy of the streaming designs' row loads: the widest of 16,
    8, 4 and 2 that divides a head slice (dh * itemsize bytes). With a
    contiguous qkv every row start and head offset is a multiple of the
    slice, so one width serves every copy: 16 (cp.async.cg) where the slice
    is whole 16-byte chunks, 8 or 4 (cp.async.ca) at e.g. bf16 head dim 12
    (24 bytes), 2 (a plain load and store) at an odd bf16 head dim."""
    return next(w for w in (16, 8, 4, 2) if (dh * itemsize) % w == 0)


def stream_smem_bytes(kind: str, dtype: torch.dtype, dp: int) -> int:
    """Shared memory a block of the streaming design of `kind` takes at the
    padded head dim dp (csrc/flash_attention_{fwd,bwd}.cu): rows of dp
    elements plus a 16-byte pad; the forward's 64 owned query rows and two
    rings (K, V) of two 32-row tiles; the backward's 128 owned rows and two
    rings of two tiles, or of one where two do not fit."""
    stride = dp * torch.tensor([], dtype=dtype).element_size() + 16
    if kind == "fwd":
        return (STREAM_BLOCK_ROWS + 4 * STREAM_TILE_ROWS) * stride
    for slots in (2, 1):
        nbytes = (2 * STREAM_BLOCK_ROWS + 2 * slots * STREAM_TILE_ROWS) * stride
        if nbytes <= SMEM_PER_BLOCK:
            return nbytes
    return nbytes


def sliced_smem_bytes(kind: str, dtype: torch.dtype) -> int:
    """Shared memory a block of the sliced design of `kind` takes: one head
    slice (SLICE_HEAD_DIM columns plus a 16-byte pad) of the forward's 64
    owned query rows and of a K and a V tile of 32 rows; of the backward's
    two planes of 64 owned rows and two tiles of 32."""
    stride = SLICE_HEAD_DIM * torch.tensor([], dtype=dtype).element_size() + 16
    owned = STREAM_BLOCK_ROWS if kind == "fwd" else 2 * STREAM_BLOCK_ROWS
    return (owned + 2 * STREAM_TILE_ROWS) * stride


def attention_design(kind: str, dtype: torch.dtype, dh: int, s: int) -> str:
    """"resident", "streaming" or "streaming_sliced": the design of `kind`
    ("fwd" or "bwd") that a CUDA call at (dtype, head dim, S) launches,
    decided before any launch. The 512 template cannot be the streaming
    design: in f32 its tiles need 396,288 bytes of shared memory a block
    (the limit is 232,448), in bf16 its backward 2 x 8 x 16 f32 accumulators
    a lane; so every head dim above 256 takes the sliced design, whose
    shared memory is that of one 256-wide slice."""
    if dh in KERNEL_HEAD_DIMS and s <= resident_max_s(kind, dtype, dh):
        return "resident"
    if dh > SLICE_HEAD_DIM:
        return "streaming_sliced"
    return "streaming"


def launch_slices(b: int, heads: int) -> list[tuple[int, int, int, int]]:
    """The launches of one call over b batch rows and `heads` heads:
    [(b0, b1, h0, h1), ...], rows b0..b1-1 and heads h0..h1-1 each, at most
    MAX_GRID_YZ of either (a launch's grid.z and grid.y), batch-major. One
    launch where both fit."""
    return [
        (b0, min(b0 + MAX_GRID_YZ, b), h0, min(h0 + MAX_GRID_YZ, heads))
        for b0 in range(0, b, MAX_GRID_YZ)
        for h0 in range(0, heads, MAX_GRID_YZ)
    ]


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


def attention_qkv_bwd_reference(
    qkv: torch.Tensor, heads: int, key_lens: torch.Tensor | None, g: torch.Tensor
) -> torch.Tensor:
    """Plain PyTorch version of the backward kernel (and of the Pallas
    `_bwd_kernel`): g (B, S, H*Dh) cotangent -> dqkv (B, S, 3*H*Dh)."""
    b, s, lanes, dh = _split_heads(qkv, heads)
    io = qkv.dtype
    scale = 1.0 / math.sqrt(dh)
    q, k, v = (x.float() for x in qkv.reshape(b, s, 3, heads, dh).unbind(2))
    gf = g.to(io).float().reshape(b, s, heads, dh)
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    if key_lens is not None:
        valid = torch.arange(s, device=qkv.device)[None, :] < key_lens.to(qkv.device)[:, None]
        logits = logits + torch.where(valid, 0.0, _NEG_INF)[:, None, None, :]
    e = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    pf = (e / e.sum(dim=-1, keepdim=True)).to(io).float()  # (B, H, Sq, Sk)
    dv = torch.einsum("bhqk,bqhd->bkhd", pf, gf)
    dp = torch.einsum("bqhd,bkhd->bhqk", gf, v)
    ds = pf * (dp - (dp * pf).sum(dim=-1, keepdim=True))
    dsb = ds.to(io).float()
    dq = torch.einsum("bhqk,bkhd->bqhd", dsb, k) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", dsb, q) * scale
    return torch.cat([x.to(io).reshape(b, s, lanes) for x in (dq, dk, dv)], dim=-1)


def _check_cuda_args(qkv, b, key_lens, what: str) -> None:
    if qkv.device.type != "cuda":
        raise ValueError(f"{what} runs on cuda or cpu tensors, not {qkv.device}")
    if qkv.dtype not in _DTYPE_CODES:
        raise ValueError(f"the CUDA kernel takes bfloat16 or float32, not {qkv.dtype}")
    if qkv.shape[1] >= 2**31:
        raise ValueError(f"the CUDA kernel takes S below 2**31, not {qkv.shape[1]}")
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


def _check_cpu_key_lens(key_lens, s: int) -> None:
    if key_lens is not None and not bool(((key_lens >= 1) & (key_lens <= s)).all()):
        raise ValueError(f"key_lens must lie in [1, {s}], got {key_lens.tolist()}")


def _attention_qkv_fwd(qkv, heads, key_lens):
    """The forward on one device: kernel on CUDA, plain version on the CPU."""
    b, s, lanes, dh = _split_heads(qkv, heads)
    if qkv.device.type == "cpu":
        _check_cpu_key_lens(key_lens, s)
        return attention_qkv_reference(qkv, heads, key_lens)
    _check_cuda_args(qkv, b, key_lens, "attention_qkv")
    from safevla_tpu_torch.ops._build import launch, load_library

    lib = load_library("flash_attention_fwd", _C_ARGTYPES)
    # the streaming entry takes the sliced design above head dim 256 too
    stream = attention_design("fwd", qkv.dtype, dh, s) != "resident"
    out = torch.empty((b, s, lanes), dtype=qkv.dtype, device=qkv.device)
    size = qkv.element_size()
    with torch.cuda.device(qkv.device):
        cuda_stream = torch.cuda.current_stream(qkv.device).cuda_stream
        for b0, b1, h0, h1 in launch_slices(b, heads):
            launch(
                lib, "attention_qkv_fwd_stream" if stream else "attention_qkv_fwd",
                qkv.data_ptr() + b0 * qkv.stride(0) * size,
                None if key_lens is None else key_lens.data_ptr() + 4 * b0,
                out.data_ptr() + b0 * s * lanes * size,
                b1 - b0, s, heads, h0, h1 - h0, dh,
                qkv.stride(0), qkv.stride(1),
                1.0 / math.sqrt(dh),
                _DTYPE_CODES[qkv.dtype],
                *([copy_width(dh, size)] if stream else []),
                cuda_stream,
            )
    attention_qkv.launches += 1
    return out


def attention_qkv_bwd(
    qkv: torch.Tensor, heads: int, key_lens: torch.Tensor | None, g: torch.Tensor
) -> torch.Tensor:
    """The attention VJP: g (B, S, H*Dh) -> dqkv (B, S, 3*H*Dh) in qkv's
    dtype (g is cast to it first, as the TPU kernel does). On a CUDA tensor
    it launches the backward kernel or raises; on a CPU tensor it runs
    `attention_qkv_bwd_reference`."""
    b, s, lanes, dh = _split_heads(qkv, heads)
    if g.shape != (b, s, lanes):
        raise ValueError(f"g must be ({b}, {s}, {lanes}), got {tuple(g.shape)}")
    if qkv.device.type == "cpu":
        _check_cpu_key_lens(key_lens, s)
        return attention_qkv_bwd_reference(qkv, heads, key_lens, g)
    _check_cuda_args(qkv, b, key_lens, "attention_qkv_bwd")
    g = g.to(qkv.dtype).contiguous()
    if g.device != qkv.device or g.data_ptr() % 16:
        raise ValueError("the CUDA kernel needs g on qkv's device, 16-byte aligned")
    from safevla_tpu_torch.ops._build import launch, load_library

    lib = load_library("flash_attention_bwd", _C_ARGTYPES_BWD)
    # the streaming entry takes the sliced design above head dim 256 too
    stream = attention_design("bwd", qkv.dtype, dh, s) != "resident"
    dqkv = torch.empty_like(qkv, memory_format=torch.contiguous_format)
    slices = launch_slices(b, heads)
    # the streaming designs' scratch: m, rowsum and D of every query row of
    # a launch, (3, its rows, its heads, S); one of the largest launch's
    # size serves each in turn (the launches run in order on one stream)
    b0, b1, h0, h1 = slices[0]
    stats = torch.empty((3, b1 - b0, h1 - h0, s), device=qkv.device) if stream else None
    size = qkv.element_size()
    with torch.cuda.device(qkv.device):
        cuda_stream = torch.cuda.current_stream(qkv.device).cuda_stream
        for b0, b1, h0, h1 in slices:
            launch(
                lib, "attention_qkv_bwd_stream" if stream else "attention_qkv_bwd",
                qkv.data_ptr() + b0 * qkv.stride(0) * size,
                g.data_ptr() + b0 * s * lanes * size,
                None if key_lens is None else key_lens.data_ptr() + 4 * b0,
                dqkv.data_ptr() + b0 * dqkv.stride(0) * size,
                *([stats.data_ptr()] if stream else []),
                b1 - b0, s, heads, h0, h1 - h0, dh,
                qkv.stride(0), qkv.stride(1),
                1.0 / math.sqrt(dh),
                _DTYPE_CODES[qkv.dtype],
                *([copy_width(dh, size)] if stream else []),
                cuda_stream,
            )
    attention_qkv_bwd.launches += 1
    return dqkv


attention_qkv_bwd.launches = 0  # kernel launches since the last reset (a plain int)


class _AttentionQKV(torch.autograd.Function):
    """attention_qkv with the flash-attention VJP as its backward. Under
    torch.utils.checkpoint the forward runs again in the backward pass, and
    the saved qkv is the recomputed one."""

    @staticmethod
    def forward(ctx, qkv, key_lens, heads):
        ctx.heads = heads
        ctx.save_for_backward(qkv, key_lens)
        return _attention_qkv_fwd(qkv, heads, key_lens)

    @staticmethod
    def backward(ctx, g):
        qkv, key_lens = ctx.saved_tensors
        return attention_qkv_bwd(qkv, ctx.heads, key_lens, g), None, None


def attention_qkv(
    qkv: torch.Tensor, heads: int, key_lens: torch.Tensor | None = None
) -> torch.Tensor:
    """Packed-projection attention: qkv (B, S, 3*H*Dh) -> (B, S, H*Dh).

    key_lens (B,) int32 (optional): count of valid keys per row, in [1, S];
    columns >= key_lens[b] are excluded from the softmax. On a CUDA tensor the
    range is checked inside the kernel (a trap), since reading a device
    tensor here would synchronise every call. Differentiable in qkv: when a
    gradient is taken, the backward is `attention_qkv_bwd`.

    On a CUDA tensor where JAX takes XLA (`kernel_takes` is False) it runs
    `dense_attention` on q, k and v folded to (B, S, H, Dh), differentiated
    by autograd. (On a CPU tensor every shape runs the plain version.)"""
    b, s, three_lanes = qkv.shape
    lanes = three_lanes // 3
    if qkv.is_cuda and not kernel_takes(lanes, heads):
        fold = lambda x: x.reshape(b, s, heads, lanes // heads)
        q, k, v = (fold(x) for x in qkv.split(lanes, dim=-1))
        mask = None
        if key_lens is not None:
            mask = torch.arange(s, device=qkv.device)[None, :] < key_lens.to(qkv.device)[:, None]
        return dense_attention(q, k, v, mask).reshape(b, s, lanes)
    if torch.is_grad_enabled() and qkv.requires_grad:
        return _AttentionQKV.apply(qkv, key_lens, heads)
    return _attention_qkv_fwd(qkv, heads, key_lens)


attention_qkv.launches = 0  # kernel launches since the last reset (a plain int)


def flash_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, key_lens: torch.Tensor | None = None
) -> torch.Tensor:
    """Attention over separate q, k, v (B, S, H, Dh) -> (B, S, H, Dh):
    packed into one (B, S, 3*H*Dh) qkv (one copy) for `attention_qkv`, so
    it runs (and differentiates) as that does."""
    b, s, h, d = q.shape
    qkv = torch.cat([x.reshape(b, s, h * d) for x in (q, k, v)], dim=-1)
    return attention_qkv(qkv, h, key_lens).reshape(b, s, h, d)


def attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    use_kernel: bool = True,
    key_mask: torch.Tensor | None = None,
    key_lens: torch.Tensor | None = None,
) -> torch.Tensor:
    """The dispatcher of JAX's `attention`: q, k, v (B, S, H, Dh) ->
    (B, S, H, Dh). `flash_attention` where the kernel's function applies
    (use_kernel, no key_mask, `kernel_takes(H*Dh, H)`), `dense_attention`
    elsewhere, with key_lens made a mask. key_mask (B, S) bool is an
    arbitrary mask; key_lens (B,) int32 a prefix mask; not both."""
    if key_mask is not None and key_lens is not None:
        raise ValueError("pass key_mask or key_lens, not both")
    h, d = q.shape[2], q.shape[3]
    if use_kernel and key_mask is None and kernel_takes(h * d, h):
        return flash_attention(q, k, v, key_lens)
    if key_lens is not None:
        key_mask = torch.arange(k.shape[1], device=k.device)[None, :] < key_lens.to(k.device)[:, None]
    return dense_attention(q, k, v, key_mask)


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
