"""The readings that a cell's limits are set from, on the card at the cell's
own size (not run by the benchmark's runs):

    python3 port_bench/calibrate.py --workload <cell> --seeds 11,12,... --control-seeds 11,12,13

For each seed, the program's compared numbers against the f32 reference
(the lower readings: the largest over the seeds). For each control seed,
the same numbers of (a) the control, the reference computed in fp8 e4m3
(the precision below the configuration's bf16: both operands and the
result of every matrix product, and the fusion's normalised stream, each
rounded with a per-tensor scale), and (b) the fault "half of the batch
left out", the reference on the first half of the rows, each put in the
program's place. Every reading carries the harness's own verdict on it,
`correct`, by the cell's limits: the program's should read true, the
control's and the fault's false. The fault "a step returns its state
unchanged" reads 1 on `change` by the measure itself and needs no run.
One JSON line a reading goes to standard output and to --out.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from port_bench import checks, harness  # noqa: E402


def free() -> None:
    import torch

    gc.collect()
    torch.cuda.empty_cache()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", default="")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    import torch

    from port_bench.reference.tower import FP8

    spec = harness.Spec(args.workload)
    harness.card_or_exit(spec.cell["chips"])
    limits = spec.workload["limits"]
    make = harness.load_module("drivers", spec.traffic["driver"]).Driver
    out = open(args.out, "a") if args.out else None
    controls = {int(s) for s in args.control_seeds.split(",") if s}

    def emit(rec):
        rec["correct"] = checks.within(rec["numbers"], limits)
        line = json.dumps(rec)
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()

    for seed in [int(s) for s in args.seeds.split(",")]:
        t0 = time.perf_counter()
        d = make(spec, seed, "cuda")
        d.setup()
        prog = d.compared
        d.free()
        del d
        free()
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        t1 = time.perf_counter()
        ref = make(spec, seed, "cuda").reference()
        t2 = time.perf_counter()
        emit({"cell": spec.name, "seed": seed, "side": "program", "numbers": checks.compare(prog, ref),
              "program_s": t1 - t0, "reference_s": t2 - t1})
        if seed in controls:
            for side, kw in (("control_fp8", {"numerics": FP8}), ("fault_half_batch", {"half": True})):
                free()
                other = make(spec, seed, "cuda").reference(**kw)
                emit({"cell": spec.name, "seed": seed, "side": side, "numbers": checks.compare(other, ref)})
        free()
    if out:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
