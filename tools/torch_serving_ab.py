#!/usr/bin/env python3
"""Serving ms/act of several checkouts of the PyTorch port, in turns, on one card.

    python3 tools/torch_serving_ab.py DIR_A DIR_B [DIR ...]

Each DIR is the root of a checkout of this repository (for example one
unpacked with `git archive`). Every DIR runs, in its own process and in the
order given, the serving phase of its own `chip_smoke.py`: its kernels
built, then `serve()` at the full default width (8 streams, 128 acts, a
profiled window and each stage alone). To compare two versions, give them
as A B B A, so that drift of the card or the host falls on both. Prints one
`[ab]` JSON line per run with the run's `[serving]`, `[profile]` and
`[stages]` numbers, and the card's name and power limit. Needs one CUDA card.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

RUN = """
import torch
import chip_smoke
from safevla_tpu_torch.ops import _build, flash_attention as fa
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
_build.build()
chip_smoke.serve(fa)
"""


def run(checkout: Path) -> dict:
    out = subprocess.run(
        [sys.executable, "-c", RUN], cwd=checkout, capture_output=True, text=True, check=True,
        timeout=900,
    )
    res = {"checkout": str(checkout)}
    for line in out.stdout.splitlines():
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
