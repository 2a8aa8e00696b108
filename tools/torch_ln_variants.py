#!/usr/bin/env python3
"""Design variants of the port's LayerNorm kernels, and the host cost of a call, on one card.

    python3 tools/torch_ln_variants.py        # from the repository root; one CUDA card

Builds `safevla_tpu_torch/csrc/layer_norm.cu` as it is ("shipped") and with
one design constant changed per variant, one nvcc each, all at once, into
the git-ignored `safevla_tpu_torch/_build/variants/`:

  half_warp_one_pass  the one-pass forward (up to a wave of blocks) with a
                   bf16 row a half-warp in 16-byte vectors, as the loop;
  warp_loop        the looping forward with a bf16 row a warp (8-byte
                   vectors), as the one pass;
  params_at_use    the forward reads gamma and beta at each row's output,
                   after its reduction, instead of holding them in
                   registers from the kernel's start;
  one_pass         the one-pass forward at every R (no looping kernel);
  fwd_4_warps      forward blocks of 4 warps, not 8;
  no_early_exit    the one-pass forward without its early exit of the
                   warps past the last row (they compute a clamped row);
  fwd_streaming_loads  the forward's x read with streaming loads (evict
                   first), as the backward's x and g;
  bwd_plain_loads  the backward's x and g read with plain loads;
  bwd_no_register_cap  the backward without its cap of two blocks an SM
                   (up to 255 registers a thread).

Each variant's registers and spills (ptxas) for the path's looping forward
and backward instantiations (bf16, D = 512) are printed. Each variant, in turn and then
the shipped one again (drift falls on both ends), is checked against the
plain version and timed at every LayerNorm shape of the path (`chip_smoke.ln_shapes`, `LN_BWD_SHAPES`; inputs cycled
over copies larger than L2): the profiler's device ms per call, twice.
Then the host time to enqueue one call at the CLS shape (16 x 512 bf16),
piece by piece: `F.layer_norm`, `ops.layer_norm.layer_norm`, the ctypes
call alone, the same call into an empty C function of the same signature,
the output's `torch.empty_like`, the wrapper's checks. Prints `[ln_variant]`
and `[ln_host]` JSON lines, `[ln_ptxas]` lines and the card's name and
power limit.
"""

from __future__ import annotations

import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from safevla_tpu_torch.ops import _build  # noqa: E402
from safevla_tpu_torch.ops import layer_norm as ln  # noqa: E402

VARIANTS = {  # name -> (text of the shipped source, its replacement)
    "shipped": None,
    "half_warp_one_pass": ("constexpr int kOnePassBf16Lanes = 32;", "constexpr int kOnePassBf16Lanes = 16;"),
    "warp_loop": ("constexpr int kLoopBf16Lanes = 16;", "constexpr int kLoopBf16Lanes = 32;"),
    "params_at_use": ("constexpr int kFwdMaxHeld = 32;", "constexpr int kFwdMaxHeld = 0;"),
    "one_pass": ("if (blocks <= one_pass_per_sm * sms) {", "if (true) {"),
    "fwd_4_warps": ("constexpr int kFwdWarps = 8;", "constexpr int kFwdWarps = 4;"),
    "no_early_exit": ("    if (base + sub >= R) return;\n", ""),
    "fwd_streaming_loads": (
        "const uint4 v = *reinterpret_cast<const uint4*>(p);\n    w[0] = v.x, w[1] = v.y, w[2] = v.z, w[3] = v.w;\n"
        "  } else {\n    const uint2 v = *reinterpret_cast<const uint2*>(p);",
        "const uint4 v = __ldcs(reinterpret_cast<const uint4*>(p));\n    w[0] = v.x, w[1] = v.y, w[2] = v.z, w[3] = v.w;\n"
        "  } else {\n    const uint2 v = __ldcs(reinterpret_cast<const uint2*>(p));"),
    "bwd_plain_loads": ("v = __ldcs(reinterpret_cast<const uint2*>(p)); }", "v = *reinterpret_cast<const uint2*>(p); }"),
    "bwd_no_register_cap": ("constexpr int kBwdMinBlocks = 2;", "constexpr int kBwdMinBlocks = 1;"),
}
# ptxas lines of the instantiations on the path: the looping forward and the
# backward, bf16, D = 512 (NV = 4)
PTXAS = {"fwd": r"layer_norm_fwd_kernelI13__nv_bfloat16S\w*?_Li4ELi\d+ELb1E", "bwd": r"layer_norm_bwd_kernelI13__nv_bfloat16S\w*?_Li4EE"}
NOOP = 'extern "C" int noop(const void*, const void*, const void*, void*, int, int, float, int, int, int, void*) { return 0; }\n'


def build_all(out: Path) -> dict:
    """One nvcc per variant (and the empty function), all at once."""
    out.mkdir(parents=True, exist_ok=True)
    source = (_build.CSRC_DIR / "layer_norm.cu").read_text()
    texts = {"noop": NOOP}
    for name, change in VARIANTS.items():
        if change is None:
            texts[name] = source
        else:
            assert source.count(change[0]) == 1, name
            texts[name] = source.replace(*change)
    procs = {}
    for name, text in texts.items():
        (out / f"{name}.cu").write_text(text)
        cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(out / f"{name}.so"), str(out / f"{name}.cu")]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for name, proc in procs.items():
        log, _ = proc.communicate()
        assert proc.returncode == 0, f"nvcc failed for {name}:\n{log}"
        for kernel, mangled in PTXAS.items():
            found = re.search(mangled + r".*?\n(.*?spill[^\n]*)\n(.*?registers[^\n]*)", log, re.S)
            if found:
                print(f"[ln_ptxas] {name} {kernel}: {found.group(1).split(chr(10))[-1].strip()}; "
                      f"{found.group(2).strip()}", flush=True)
    return {name: out / f"{name}.so" for name in texts}


def use(library: Path) -> None:
    """Route `ops.layer_norm` to this build of the library."""
    _build._LIBS["layer_norm"] = ctypes.CDLL(str(library))
    ln._C = None
    ln._MAX_BLOCKS.clear()


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_ln_variants: needs one CUDA card", file=sys.stderr)
        return 2
    print(cs.card_line(), flush=True)
    libs = build_all(_build.BUILD_DIR / "variants")
    gen = torch.Generator(device="cuda").manual_seed(0)
    fwd = {}
    for name, r, d, dt, odt in cs.ln_shapes():
        x, gamma, beta = cs._ln_inputs(r, d, dt, gen)
        fwd[name] = (cs.rotation(x), gamma, beta, odt)
    bwd = {}
    for name, r, d in cs.LN_BWD_SHAPES:
        x, gamma, _ = cs._ln_inputs(r, d, torch.bfloat16, gen)
        g = torch.randn((r, d), generator=gen, device="cuda").to(torch.bfloat16)
        bwd[name] = (cs.rotation(x, g), gamma)

    for name in [*VARIANTS, "shipped"]:
        use(libs[name])
        res = {"variant": name, "forward": {}, "backward": {}}
        for shape, (xs, gamma, beta, odt) in fwd.items():
            got = ln.layer_norm(xs[0][0], gamma, beta, 1e-6, odt)
            want = ln.layer_norm_fwd_reference(xs[0][0], gamma, beta, 1e-6, odt)
            assert cs.ln_excess(got, want) <= 1, (name, shape)
            call = cs.cycling(lambda a: ln.layer_norm(a, gamma, beta, 1e-6, odt), xs)
            res["forward"][shape] = [cs.device_ms_per_call(call) for _ in range(2)]
        for shape, (sets, gamma) in bwd.items():
            x, g = sets[0]
            got, again = ln.layer_norm_bwd(x, gamma, g), ln.layer_norm_bwd(x, gamma, g)
            assert all(torch.equal(a, b) for a, b in zip(got, again)), (name, shape)
            assert cs.ln_excess(got[0], ln.layer_norm_bwd_reference(x, gamma, g)[0]) <= 1, (name, shape)
            call = cs.cycling(lambda a, b: ln.layer_norm_bwd(a, gamma, b), sets)
            res["backward"][shape] = [cs.device_ms_per_call(call) for _ in range(2)]
        print(f"[ln_variant] {json.dumps(res)}", flush=True)

    x, gamma, beta = cs._ln_inputs(16, 512, torch.bfloat16, gen)
    out = torch.empty_like(x)
    gl, bl = gamma.bfloat16(), beta.bfloat16()
    c = ln._C
    noop = ctypes.CDLL(str(libs["noop"]))["noop"]
    noop.argtypes, noop.restype = ln._C_ARGTYPES["layer_norm_fwd"]
    ptrs = (x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), out.data_ptr())
    stream = c.stream(0)
    pieces = {
        "F.layer_norm": lambda: F.layer_norm(x, (512,), gl, bl, 1e-6),
        "layer_norm": lambda: ln.layer_norm(x, gamma, beta, 1e-6, torch.bfloat16),
        "ctypes_call": lambda: c.layer_norm_fwd(*ptrs, 16, 512, 1e-6, 0, 0, 0, stream),
        "ctypes_call_empty_function": lambda: noop(*ptrs, 16, 512, 1e-6, 0, 0, 0, stream),
        "empty_like": lambda: torch.empty_like(x),
        "checks": lambda: ln._check_cuda(x, 0, 512, gamma, 0, "layer_norm"),
    }
    host = {k: cs.median3(cs.host_us, fn) for k, fn in pieces.items()}
    print(f"[ln_host] {json.dumps({'shape': [16, 512], 'host_us': host})}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
