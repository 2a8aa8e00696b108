#!/usr/bin/env python3
"""LayerNorm kernel times of several checkouts of the PyTorch port, in turns, on one card.

    python3 tools/torch_ln_ab.py DIR_A DIR_B [DIR ...]

Each DIR is the root of a checkout of this repository (for example one
unpacked with `git archive`). Every DIR runs, in its own process and in the
order given, its own kernels and wrapper (`safevla_tpu_torch.ops.layer_norm`,
built from its csrc/) through this repository's `chip_smoke.py` checks:
`check_layer_norm` at every forward shape of the path and
`check_layer_norm_bwd` at both backward shapes, so that every checkout is
checked against its plain version and timed by the same code: CUDA-event
ms, host µs to enqueue a call, profiler device ms and kernels per call,
plain ms, `F.layer_norm` ms, host µs and device ms, bound. The inputs come
from one seed. To compare two versions, give them as A B B A, so that drift
of the card or the host falls on both. Prints one `[ln_ab]` JSON line per
run with the card's name and power limit. Needs one CUDA card.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

SMOKE = Path(__file__).resolve().parent.parent / "chip_smoke.py"
RUN = """
import importlib.util, sys
import torch
spec = importlib.util.spec_from_file_location("smoke_checks", sys.argv[1])
cs = importlib.util.module_from_spec(spec)
spec.loader.exec_module(cs)
from safevla_tpu_torch.ops import _build, layer_norm as ln
_build.build()
gen = torch.Generator(device="cuda").manual_seed(0)
for shape in cs.ln_shapes():
    cs.check_layer_norm(ln, *shape, gen)
for shape in cs.LN_BWD_SHAPES:
    cs.check_layer_norm_bwd(ln, *shape, gen)
"""
KEYS = ("ms", "host_us", "device_ms", "kernels_per_call", "plain_ms", "library_ms", "library_host_us",
        "library_device_ms", "bound_ms", "max_abs_err")


def run(checkout: Path) -> dict:
    out = subprocess.run(
        [sys.executable, "-c", RUN, str(SMOKE)], cwd=checkout, capture_output=True, text=True,
        check=True, timeout=900,
    )
    res = {"checkout": str(checkout), "forward": {}, "backward": {}}
    for line in out.stdout.splitlines():
        for tag, part in (("[kernels] layer_norm {", "forward"), ("[kernels] layer_norm_bwd {", "backward")):
            if line.startswith(tag):
                row = json.loads(line[len(tag) - 1:])
                res[part][row["shape"]] = {k: row[k] for k in KEYS if k in row}
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
        print(f"[ln_ab] {json.dumps(res)}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
