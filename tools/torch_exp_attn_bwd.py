#!/usr/bin/env python3
"""The attention backward's matmul-only floor on one CUDA card: the port's
counterpart of tools/exp_attn_bwd.py.

    python3 tools/torch_exp_attn_bwd.py      # from the repository root; one CUDA card

The TPU tool times variants of the Pallas attention backward at the fusion
update's shape (B=384, S=201, H=8, Dh=64, bf16): `cur`, the in-tree kernel;
`bf16p`, probabilities and ds rounded to bf16, which the JAX package took as
its `_bwd_kernel`; and `mmonly`, the backward's five products with the
softmax replaced by a scale (its matmul-only floor). Here, at the same
shape, on inputs made from a seed:

  cur / bf16p  the port's `attention_qkv_bwd` (csrc/flash_attention_bwd.cu,
               the port of `_bwd_kernel`), keys masked by `kl`;
  mmonly       csrc/exp_attn_bwd.cu through `mmonly`: no key mask, all S
               keys count, as in the TPU variant (a persistent kernel on
               wgmma, with TMA loads into an mbarrier ring);
  sdpa         PyTorch SDPA's backward with a boolean key mask from `kl`.

Each is printed as CUDA-event ms (the median of 3 timings) and TFLOP/s at
the TPU tool's count 5 * 2 * S * S * Dh * H * B, then the ratio cur / mmonly
(row 2's time over its products' time: what the softmax recompute and the
masking add) and mmonly's bound, and one JSON line of all of it beside the
card's name and power limit. Before the timings `mmonly` is held against
`mmonly_reference` on the same inputs.

The TPU tool's sweep over G (2, 4, 8 batch rows per VMEM grid step) has no
counterpart on the card: a block of `cur` is one (head, batch row), and
`mmonly`'s persistent blocks walk the (batch row, head) items in turn.

Importing this module runs nothing. `mmonly_reference` is the plain
PyTorch version at the kernel's rounding points; `mmonly` launches the
kernel on a CUDA tensor (or raises) and runs the plain version on a CPU
tensor, as the port's wrappers do.
"""

from __future__ import annotations

import ctypes
import json
import math
import os
import subprocess
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from safevla_tpu_torch.ops import flash_attention as fa  # noqa: E402

B, S, H, DH = 384, 201, 8, 64  # the TPU tool's shape
KL_LOW = 170  # key counts drawn from [KL_LOW, S], as the TPU tool draws them
MM_SCALE = 0.001  # the TPU variant's stand-in for the softmax
TOL_REL = 1e-2  # kernel vs plain: 1e-2 of the largest |value| (bf16 roundings of pb, dsb)
PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core rate
PEAK_BYTES = 3.35e12  # H100 SXM HBM3 rate
_VOID, _INT = ctypes.c_void_p, ctypes.c_int
_C_ARGTYPES = {
    "exp_attn_bwd_mmonly": (
        [
            _VOID, _VOID, _VOID,  # qkv, g, dqkv
            _INT, _INT, _INT, _INT,  # B, S, H, Dh
            ctypes.c_longlong, ctypes.c_longlong,  # qkv / dqkv stride_b, stride_s (elements)
            ctypes.c_float, _VOID,  # scale, stream
        ],
        _INT,
    ),
    "exp_attn_bwd_error_string": ([_INT], ctypes.c_char_p),
}
_C = None  # the library's C functions, bound at the first launch


def mmonly_max_s(dh: int) -> int:
    """The largest S the kernel takes at head dim dh: the 4 plane slots of
    one item (round16(S) bf16 rows and 16 bytes of mbarriers each) fit in
    the shared memory of a block. The kernel's launch refuses past the same
    line; how many more slots it takes is its own choice."""
    return 16 * ((fa.SMEM_PER_BLOCK // 4 - 16) // (16 * 2 * dh))


def mmonly_bound(b: int, s: int, heads: int, dh: int):
    """(ms, "bytes" or "operations"): the least time of mmonly's work on an
    H100, qkv and g read once and dqkv written once (bf16) at the HBM rate
    against its five products, 10 * B * H * S * S * Dh flops, at the bf16
    peak."""
    t_bytes = 2 * 7 * b * s * heads * dh / PEAK_BYTES
    t_ops = 10.0 * b * heads * s * s * dh / PEAK_BF16_FLOPS
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops > t_bytes else "bytes")


def mmonly_reference(qkv: torch.Tensor, g: torch.Tensor, heads: int) -> torch.Tensor:
    """Plain PyTorch version of the kernel (and of the TPU tool's variant):
    qkv (B, S, 3*H*Dh), g (B, S, H*Dh) -> dqkv (B, S, 3*H*Dh) in qkv's dtype.
    f32 products; pb and dsb rounded to qkv's dtype after the f32 scale."""
    b, s, lanes, dh = fa._split_heads(qkv, heads)
    io = qkv.dtype
    scale = 1.0 / math.sqrt(dh)
    q, k, v = (x.float() for x in qkv.reshape(b, s, 3, heads, dh).unbind(2))
    gf = g.to(io).float().reshape(b, s, heads, dh)
    pb = (torch.einsum("bqhd,bkhd->bhqk", q, k) * MM_SCALE).to(io).float()
    dv = torch.einsum("bhqk,bqhd->bkhd", pb, gf)
    dsb = (torch.einsum("bqhd,bkhd->bhqk", gf, v) * MM_SCALE).to(io).float()
    dq = torch.einsum("bhqk,bkhd->bqhd", dsb, k) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", dsb, q) * scale
    return torch.cat([x.to(io).reshape(b, s, lanes) for x in (dq, dk, dv)], dim=-1)


def _bind():
    global _C
    from safevla_tpu_torch.ops._build import bind

    _C = bind("exp_attn_bwd", _C_ARGTYPES)
    return _C


def mmonly(qkv: torch.Tensor, g: torch.Tensor, heads: int) -> torch.Tensor:
    """The matmul-only backward: csrc/exp_attn_bwd.cu on a CUDA tensor (bf16,
    head dims 16, 32, 64, 128, S up to `mmonly_max_s`, contiguous inputs;
    anything else raises), `mmonly_reference` on a CPU tensor."""
    b, s, lanes, dh = fa._split_heads(qkv, heads)
    if g.shape != (b, s, lanes):
        raise ValueError(f"g must be ({b}, {s}, {lanes}), got {tuple(g.shape)}")
    if qkv.device.type == "cpu":
        return mmonly_reference(qkv, g, heads)
    if qkv.device.type != "cuda" or g.device != qkv.device:
        raise ValueError(f"mmonly runs on cuda or cpu tensors, qkv and g on one device, not {qkv.device}, {g.device}")
    if qkv.dtype != torch.bfloat16 or g.dtype != torch.bfloat16:
        raise ValueError(f"the CUDA kernel takes bfloat16 qkv and g, not {qkv.dtype}, {g.dtype}")
    if dh not in fa.KERNEL_HEAD_DIMS:
        raise ValueError(f"the CUDA kernel takes head dims {fa.KERNEL_HEAD_DIMS}, not {dh}")
    if s > mmonly_max_s(dh):
        raise ValueError(f"the CUDA kernel takes S up to {mmonly_max_s(dh)} at head dim {dh}, not {s}")
    if b > fa.MAX_GRID_YZ or heads > fa.MAX_GRID_YZ:
        raise ValueError(f"the CUDA kernel takes up to {fa.MAX_GRID_YZ} batch rows and heads")
    if not (qkv.is_contiguous() and g.is_contiguous()) or qkv.data_ptr() % 16 or g.data_ptr() % 16:
        raise ValueError("the CUDA kernel needs contiguous, 16-byte aligned qkv and g")
    c = _C or _bind()
    dqkv = torch.empty_like(qkv)
    with torch.cuda.device(qkv.device):
        c.exp_attn_bwd_mmonly(
            qkv.data_ptr(), g.data_ptr(), dqkv.data_ptr(), b, s, heads, dh,
            qkv.stride(0), qkv.stride(1), 1.0 / math.sqrt(dh),
            torch.cuda.current_stream(qkv.device).cuda_stream,
        )
    mmonly.launches += 1
    return dqkv


mmonly.launches = 0  # kernel launches since the last reset (a plain int)


def inputs(b: int, s: int, heads: int, dh: int, seed: int = 0):
    """qkv (B, S, 3*H*Dh) and g (B, S, H*Dh) on the card, N(0, 1) in bf16
    from a seed, and the key counts kl (B,) int32 from
    np.random.RandomState(seed) over [min(KL_LOW, S), S], as the TPU tool
    draws them."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    qkv = torch.randn((b, s, 3 * heads * dh), generator=gen, device="cuda").to(torch.bfloat16)
    g = torch.randn((b, s, heads * dh), generator=gen, device="cuda").to(torch.bfloat16)
    kl = np.random.RandomState(seed).randint(min(KL_LOW, s), s + 1, (b,))
    return qkv, g, torch.tensor(kl, dtype=torch.int32, device="cuda")


def sdpa_backward(qkv: torch.Tensor, g: torch.Tensor, kl: torch.Tensor, heads: int):
    """A function that runs SDPA's backward (torch.autograd.grad alone) on
    qkv's q, k and v with the boolean key mask of kl, the cotangent g."""
    import torch.nn.functional as F

    b, s, lanes, dh = fa._split_heads(qkv, heads)
    q, k, v = (t.detach().requires_grad_(True) for t in qkv.view(b, s, 3, heads, dh).permute(2, 0, 3, 1, 4))
    mask = (torch.arange(s, device=qkv.device)[None, :] < kl[:, None])[:, None, None, :]
    out = F.scaled_dot_product_attention(q, k, v, attn_mask=mask)
    g4 = g.view(b, s, heads, dh).permute(0, 2, 1, 3)
    return lambda: torch.autograd.grad(out, (q, k, v), g4, retain_graph=True)


def median_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """The median of 3 timings, each the CUDA-event mean over `iters`
    back-to-back calls of fn."""
    for _ in range(warmup):
        fn()
    runs = []
    for _ in range(3):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        runs.append(start.elapsed_time(end) / iters)
    return float(np.median(runs))


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_exp_attn_bwd: CUDA is not available; this needs one CUDA card", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(card, flush=True)
    qkv, g, kl = inputs(B, S, H, DH)
    got, want = mmonly(qkv, g, H), mmonly_reference(qkv, g, H)
    err = (got.float() - want.float()).abs().max().item()
    magnitude = want.float().abs().max().item()
    if not (torch.isfinite(got).all() and err <= TOL_REL * magnitude):
        raise RuntimeError(f"mmonly vs mmonly_reference: max abs err {err} > {TOL_REL} x {magnitude}")
    variants = {
        "cur": lambda: fa.attention_qkv_bwd(qkv, H, kl, g),
        "mmonly": lambda: mmonly(qkv, g, H),
        "sdpa": sdpa_backward(qkv, g, kl, H),
    }
    flop = 5 * 2 * S * S * DH * H * B
    times = {}
    for name, fn in variants.items():
        times[name] = median_ms(fn)
        label = "cur/bf16p" if name == "cur" else name
        print(f"{label:9s} {times[name]:8.4f} ms  ({flop / times[name] / 1e9:6.1f} TFLOP/s)", flush=True)
    bound_ms, bound_by = mmonly_bound(B, S, H, DH)
    ratio = times["cur"] / times["mmonly"]
    print(f"cur / mmonly {ratio:.3f}; mmonly's bound {bound_ms:.4f} ms (set by {bound_by})", flush=True)
    print(json.dumps({
        "card": card, "shape": {"B": B, "S": S, "H": H, "Dh": DH}, "flop": flop,
        "ms": times, "tflops": {k: flop / t / 1e9 for k, t in times.items()},
        "cur_over_mmonly": ratio, "mmonly_bound_ms": bound_ms, "mmonly_bound_by": bound_by,
        "mmonly_max_abs_err": err, "mmonly_max_abs_want": magnitude,
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
