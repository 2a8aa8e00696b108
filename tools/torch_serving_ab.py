#!/usr/bin/env python3
"""Attention kernel times and serving ms/act of several checkouts of the PyTorch port, in turns, on one card.

    python3 tools/torch_serving_ab.py DIR_A DIR_B [DIR ...]

Each DIR is the root of a checkout of this repository (for example one
unpacked with `git archive`). Every DIR runs, in its own process and in the
order given, its own `chip_smoke.py`: its kernels built, `check_attention`
at the path's five attention shapes (the ViT and the fusion at serving, in
the rollout, and the update's fusion chunk) and `check_attention_bwd` at the
update's shape (each kernel checked against its plain version and timed:
CUDA-event ms, profiler device ms, plain ms, SDPA ms, bound), then `serve()`
at the full default width (8 streams, 128 acts, a profiled window and each
stage alone). To compare two versions, give them as A B B A, so that drift
of the card or the host falls on both. Prints one `[ab]` JSON line per run
with the run's `[kernels]`, `[serving]`, `[profile]` and `[stages]` numbers,
and the card's name and power limit. Needs one CUDA card.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

RUN = """
import torch
import chip_smoke as cs
from safevla_tpu_torch.ops import _build, flash_attention as fa
from safevla_tpu_torch.preprocessing.tokenize import InstructionTokenizer
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
_build.build()
gen = torch.Generator(device="cuda").manual_seed(0)
_, mask = InstructionTokenizer("t5-small", 32).encode_batch(cs.INSTRUCTIONS)
fusion_kl = [169 + int(n) for n in mask.sum(-1)]
g = cs.TRAINER_STREAMS // cs.TRAINER_GROUPS
update_kl = [fusion_kl[i % len(fusion_kl)] for i in range(128)]
cs.check_attention(fa, "vit", 2 * cs.STREAMS, 448, 6, [433] * (2 * cs.STREAMS), gen)
cs.check_attention(fa, "fusion", cs.STREAMS, 208, 8, fusion_kl, gen)
cs.check_attention(fa, "vit_rollout", 2 * g, 448, 6, [433] * (2 * g), gen)
cs.check_attention(fa, "fusion_rollout", g, 208, 8, [fusion_kl[i % len(fusion_kl)] for i in range(g)], gen)
cs.check_attention(fa, "fusion_update", 128, 208, 8, update_kl, gen)
cs.check_attention_bwd(fa, "fusion_update_bwd", 128, 208, 8, update_kl, gen)
cs.serve(fa)
"""
KERNEL_KEYS = ("ms", "device_ms", "plain_ms", "library_ms", "bound_ms", "max_abs_err")


def run(checkout: Path) -> dict:
    out = subprocess.run(
        [sys.executable, "-c", RUN], cwd=checkout, capture_output=True, text=True, check=True,
        timeout=900,
    )
    res = {"checkout": str(checkout), "kernels": {}}
    for line in out.stdout.splitlines():
        if line.startswith("[kernels] {"):
            row = json.loads(line[len("[kernels] "):])
            res["kernels"][row["shape"]] = {k: row[k] for k in KERNEL_KEYS}
        for tag in ("serving", "profile", "stages"):
            prefix = f"[{tag}] "
            if line.startswith(prefix + "{"):
                res.setdefault(tag, {}).update(json.loads(line[len(prefix):]))
    return res


def main() -> int:
    if len(sys.argv) < 3:
        print(__doc__, file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    for d in sys.argv[1:]:
        res = run(Path(d).resolve())
        res["card"] = card
        print(f"[ab] {json.dumps(res)}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
