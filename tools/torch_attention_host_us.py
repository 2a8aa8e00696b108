#!/usr/bin/env python3
"""Host time of a call of the attention kernels' wrappers, with its spread,
on one CUDA card.

    python3 tools/torch_attention_host_us.py                 # from the repository root
    python3 tools/torch_attention_host_us.py --package-root DIR --label parent

At each path shape of the forward (`attention_qkv`, csrc/flash_attention_fwd.cu)
and the backward (`attention_qkv_bwd`, csrc/flash_attention_bwd.cu), in bf16
at head dim 64, on inputs made from a seed, it prints one JSON line with:

  wrapper_host_us   host µs to enqueue one wrapper call;
  entry_host_us     the same for the C entry alone (`attention_qkv_fwd` /
                    `attention_qkv_bwd`, its arguments made once and passed
                    through ctypes, as the wrapper passes them);
  stream_entry_host_us
                    the streaming design's C entry at the same shape, which
                    encodes no tensor map: entry minus this is what the
                    resident entry adds on the host (its maps, its grid);
                    not at vit_offline, where the streaming design's device
                    time would hold the run for a minute;
  device_ms         the kernel's device time a call, from torch.profiler.

Each host figure is ROUNDS readings of CALLS back-to-back calls, the
synchronise outside each reading; each device figure DEVICE_ROUNDS profiled
runs of DEVICE_CALLS calls. Each is printed as median, min,
max and the quartiles. Then one line for cuTensorMapEncodeTiled alone (the resident
bf16 entries encode one map a forward and two a backward): the driver's
function called through ctypes with a forward's arguments at the ViT shape,
beside a ctypes call of cuDriverGetVersion, the floor of any ctypes call.
Every line carries `--label` and the card's name and power limit.

`--package-root DIR` imports `safevla_tpu_torch` from DIR instead (an
unpacked earlier commit with the same C entries), so two trees are compared
in one run on one card: run parent, change, change, parent. Importing this
module runs nothing; it imports no JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DH = 64
ROUNDS, CALLS = 15, 200  # host readings, calls a reading
DEVICE_ROUNDS, DEVICE_CALLS = 3, 20  # profiled runs, calls a run
UPDATE_KEY_LENS = [169 + n for n in (7, 12, 5, 9, 30, 2, 21, 16)]  # fusion key counts (1 + 2 * 84 + text)
SIGLIP_KEY_LENS = [169 + n for n in (7, 12, 64, 5, 30, 64, 2, 9)]
# (name, B, S, H, key_lens): the smoke's path shapes of rows 1 and 2
FWD_SHAPES = [
    ("vit", 16, 448, 6, [433] * 16),
    ("vit_online", 8, 448, 6, [433] * 8),
    ("vit_rollout", 32, 448, 6, [433] * 32),
    ("vit_siglip", 16, 256, 12, [256] * 16),
    ("vit_siglip_online", 8, 256, 12, [256] * 8),
    ("fusion_online", 4, 208, 8, UPDATE_KEY_LENS[:4]),
    ("fusion_update", 128, 208, 8, UPDATE_KEY_LENS * 16),
    ("vit_offline", 1600, 448, 6, [433] * 1600),
]
BWD_SHAPES = [
    ("fusion_update", 128, 208, 8, UPDATE_KEY_LENS * 16),
    ("fusion_bwd_chunk", 32, 208, 8, UPDATE_KEY_LENS * 4),
    ("fusion_offline", 100, 208, 8, (UPDATE_KEY_LENS * 13)[:100]),
    ("fusion_siglip_update", 128, 240, 8, SIGLIP_KEY_LENS * 16),
]


def spread(xs) -> dict:
    """Median, min, max and quartiles of the readings."""
    q1, med, q3 = np.percentile(xs, [25, 50, 75])
    return {"median": float(med), "min": float(min(xs)), "max": float(max(xs)), "q1": float(q1),
            "q3": float(q3), "n": len(xs)}


def host_us(torch, fn, calls: int) -> float:
    """Host µs to enqueue one fn(): calls back-to-back, synchronised outside."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / calls * 1e6


def device_ms(torch, fn, calls: int):
    """Device ms of one fn() (all its kernels) from the profiler; None when
    it saw no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    ns = sum(e.duration_ns() for e in prof.profiler.kineto_results.events() if e.device_type() == DeviceType.CUDA)
    return ns / 1e6 / calls if ns else None


def entries(torch, fa, kind, qkv, g, kl, heads):
    """(resident entry, streaming entry) of `kind` as zero-argument calls
    with their arguments made once, one launch each (the shapes here need
    no launch split)."""
    from safevla_tpu_torch.ops._build import launch, load_library

    b, s, three = qkv.shape
    lanes = three // 3
    stream = torch.cuda.current_stream().cuda_stream
    common = (b, s, heads, 0, heads, DH, qkv.stride(0), qkv.stride(1), 1.0 / math.sqrt(DH), 0)
    width = fa.copy_width(DH, 2)
    if kind == "fwd":
        lib = load_library("flash_attention_fwd", fa._C_ARGTYPES)
        out = torch.empty((b, s, lanes), dtype=qkv.dtype, device="cuda")
        ptrs = (qkv.data_ptr(), kl.data_ptr(), out.data_ptr())
        return (lambda: launch(lib, "attention_qkv_fwd", *ptrs, *common, stream),
                lambda: launch(lib, "attention_qkv_fwd_stream", *ptrs, *common, width, stream), out)
    lib = load_library("flash_attention_bwd", fa._C_ARGTYPES_BWD)
    dqkv = torch.empty_like(qkv)
    stats = torch.empty((3, b, heads, s), device="cuda")
    ptrs = (qkv.data_ptr(), g.data_ptr(), kl.data_ptr(), dqkv.data_ptr())
    return (lambda: launch(lib, "attention_qkv_bwd", *ptrs, *common, stream),
            lambda: launch(lib, "attention_qkv_bwd_stream", *ptrs, stats.data_ptr(), *common, width, stream),
            (dqkv, stats))


def encode_cost(torch, calls: int, rounds: int) -> dict:
    """Host µs of one cuTensorMapEncodeTiled with the forward's map at the
    ViT shape (4-d: head dims, head slot, row, batch row; 64 x 64 boxes,
    128-byte swizzle), beside one cuDriverGetVersion, both through ctypes."""
    cuda = ctypes.CDLL("libcuda.so.1")
    b, s, heads = 16, 448, 6
    qkv = torch.empty((b, s, 3 * heads * DH), dtype=torch.bfloat16, device="cuda")
    buf = (ctypes.c_uint8 * 256)()
    addr = (ctypes.addressof(buf) + 63) // 64 * 64  # a CUtensorMap is 64-byte aligned
    u64x4, u64x3, u32x4 = ctypes.c_uint64 * 4, ctypes.c_uint64 * 3, ctypes.c_uint32 * 4
    dims = u64x4(DH, 3 * heads, s, b)
    strides = u64x3(2 * DH, 2 * qkv.stride(1), 2 * qkv.stride(0))
    box, unit = u32x4(DH, 1, 64, 1), u32x4(1, 1, 1, 1)
    encode = cuda.cuTensorMapEncodeTiled
    encode.restype = ctypes.c_int
    # data type 9 bf16; interleave none (0), swizzle 128B (3), L2 256B (3), fill none (0)
    args = (ctypes.c_void_p(addr), 9, 4, ctypes.c_void_p(qkv.data_ptr()), dims, strides, box, unit, 0, 3, 3, 0)
    assert encode(*args) == 0, "cuTensorMapEncodeTiled refused the forward's map"
    version = ctypes.c_int()
    get_version = cuda.cuDriverGetVersion

    def per_call(fn):
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        return (time.perf_counter() - t0) / calls * 1e6

    enc = [per_call(lambda: encode(*args)) for _ in range(rounds)]
    floor = [per_call(lambda: get_version(ctypes.byref(version))) for _ in range(rounds)]
    return {"encode_us": spread(enc), "ctypes_floor_us": spread(floor),
            "encode_minus_floor_us": float(np.median(enc) - np.median(floor))}


def card() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "unknown"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--package-root", default=REPO, help="import safevla_tpu_torch from here")
    ap.add_argument("--label", default="this tree")
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.package_root))
    import torch

    from safevla_tpu_torch.ops import flash_attention as fa

    package = os.path.dirname(os.path.dirname(os.path.abspath(fa.__file__)))
    assert os.path.dirname(package) == os.path.abspath(args.package_root), package
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    gpu = card()
    print(gpu, flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    for kind, shapes in (("fwd", FWD_SHAPES), ("bwd", BWD_SHAPES)):
        for name, b, s, heads, key_lens in shapes:
            assert fa.attention_design(kind, torch.bfloat16, DH, s) == "resident", (kind, name)
            lanes = heads * DH
            qkv = torch.randn((b, s, 3 * lanes), generator=gen, device="cuda").to(torch.bfloat16)
            g = torch.randn((b, s, lanes), generator=gen, device="cuda").to(torch.bfloat16)
            kl = torch.tensor(key_lens, dtype=torch.int32, device="cuda")
            if kind == "fwd":
                wrapper = lambda: fa.attention_qkv(qkv, heads, kl)
            else:
                wrapper = lambda: fa.attention_qkv_bwd(qkv, heads, kl, g)
            resident, streaming, _keep = entries(torch, fa, kind, qkv, g, kl, heads)
            for fn in (wrapper, resident, streaming):  # warm: first launches
                fn()
            torch.cuda.synchronize()
            res = {"label": args.label, "kind": kind, "shape": name, "b": b, "s": s, "heads": heads}
            timed = [("wrapper_host_us", wrapper), ("entry_host_us", resident)]
            if name != "vit_offline":
                timed.append(("stream_entry_host_us", streaming))
            for key, fn in timed:
                res[key] = spread([host_us(torch, fn, CALLS) for _ in range(ROUNDS)])
            dev = [device_ms(torch, resident, DEVICE_CALLS) for _ in range(DEVICE_ROUNDS)]
            res["device_ms"] = spread([d for d in dev if d]) if any(dev) else None
            res["card"] = gpu
            print(json.dumps(res), flush=True)
    enc = encode_cost(torch, 20 * CALLS, ROUNDS)
    print(json.dumps({"label": args.label, "kind": "cuTensorMapEncodeTiled", **enc, "card": gpu}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
