"""The benchmark of the PyTorch / CUDA port: one cell, one run.

    python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything that belongs to one configuration, traffic mix or metric is a
file of its own, found by the name that `BENCHMARK.json` gives:

    port_bench/configs/<config>.json    sizes, the program's Config overrides
    port_bench/traffic/<traffic>.json   the driver's name and its parameters
    port_bench/workloads/<cell>.json    the limits of the cell's correctness check
    port_bench/drivers/<driver>.py      builds the inputs, runs set-up, the
                                        window and the reference steps
    port_bench/metrics/<metric>.py      reads one metric from the run's record;
                                        `<base>.<suffix>` falls back on
                                        metrics/<base>.py where it has no file

A run: set-up (the program, its weights and inputs from the seed, the first
steps through the window's own call), the timed window; with `--trace 1`
then a shorter window under the profiler, which the trace's metrics read
(the profiler slows the host, so the rates and mfu come from the timed
window, which runs without it); then, once the program's state is freed, the plain
reference over the same first steps; the numbers compared are printed
beside their limits, on standard error and as the result line's last key.
"""

from __future__ import annotations

import argparse
import gc
import importlib.util
import json
import sys
import time
from pathlib import Path
from typing import List, Optional

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
# top-level module names a run may not load, compared whole
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "safevla_tpu")
TRACED_SECONDS = 10.0  # the traced window's length (at most the run's --seconds)


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def find(items: List[dict], name: str, what: str) -> dict:
    for item in items:
        if item["name"] == name:
            return item
    raise SystemExit(f"no {what} named {name!r} in BENCHMARK.json")


def load_module(kind: str, name: str):
    """port_bench/<kind>/<name>.py as a module (names may hold dots)."""
    path = BENCH_DIR / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"port_bench_{kind}_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_file(name: str) -> Path:
    """metrics/<name>.py, or for `<base>.<suffix>` without a file of its
    own, metrics/<base>.py (one reader for a metric split by cell)."""
    path = BENCH_DIR / "metrics" / f"{name}.py"
    return path if path.exists() or "." not in name else metric_file(name.rsplit(".", 1)[0])


def load_metric(name: str):
    return load_module("metrics", metric_file(name).stem)


def forbidden_modules() -> List[str]:
    return sorted({n.split(".")[0] for n in list(sys.modules)} & set(FORBIDDEN))


def cell_metrics(bench: dict, cell: str, trace: bool) -> List[dict]:
    """The cell's end-to-end metrics, or with `trace` its per-layer ones."""
    if trace:
        return [m for m in bench["per_layer"] if cell in m["workloads"]]
    return [m for m in bench["end_to_end"] if "workloads" not in m or cell in m["workloads"]]


class Spec:
    """A cell with its configuration, traffic and limits, read by name."""

    def __init__(self, cell: str, bench: Optional[dict] = None):
        self.bench = bench or benchmark()
        self.cell = find(self.bench["workloads"], cell, "workload")
        self.name = cell
        self.config = load_json(BENCH_DIR / "configs" / f"{self.cell['config']}.json")
        self.traffic = load_json(BENCH_DIR / "traffic" / f"{self.cell['traffic']}.json")
        self.workload = load_json(BENCH_DIR / "workloads" / f"{cell}.json")


def card_or_exit(chips: int) -> None:
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"port_bench: this cell needs {chips} CUDA card(s); found {n}", file=sys.stderr)
        raise SystemExit(3)


def device_info(device) -> dict:
    import torch

    if torch.device(device).type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    return {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": 1,
        "memory_peak_bytes": int(torch.cuda.max_memory_allocated()),
    }


def synchronize(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def run_cell(spec: Spec, seed: int, seconds: float, trace: bool, device="cuda", t_start: Optional[float] = None,
             patch=None):
    """One run of a cell -> (the result object, the run's last line; the
    lines that give each compared number beside its limit). `patch`, for
    the tests, breaks the program before set-up runs."""
    import torch

    from port_bench import checks
    from port_bench import trace as tracing

    t_start = time.perf_counter() if t_start is None else t_start
    driver = load_module("drivers", spec.traffic["driver"]).Driver(spec, seed, device)
    if patch is not None:
        patch(driver)
    driver.setup()
    synchronize(device)
    setup_s = time.perf_counter() - t_start

    window = driver.window(seconds)
    t_window = time.perf_counter()
    trace_rec = None
    if trace:
        prof = tracing.start(device)
        trace_rec = tracing.stop(prof, driver.window(min(seconds, TRACED_SECONDS)))
    t_trace = time.perf_counter()
    memory = device_info(device)

    outcomes = driver.outcomes()
    program = driver.compared
    driver.free()
    del driver
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ref_driver = load_module("drivers", spec.traffic["driver"]).Driver(spec, seed, device)
    reference = ref_driver.reference()
    del ref_driver
    t_ref = time.perf_counter()
    found = checks.compare(program, reference)
    limits = spec.workload["limits"]
    traced = f", traced window and its reduction {t_trace - t_window:.3f} s ({trace_rec['steps']} steps)" if trace else ""
    lines = [f"port_bench: setup {setup_s:.3f} s, window {window['t1'] - window['t0']:.3f} s "
             f"({window['steps']} steps){traced}, reference {t_ref - t_trace:.3f} s"] + checks.lines(found, limits)
    failed = sum(1 for ok in outcomes if not ok)
    correct = bool(failed == 0 and checks.within(found, limits))

    record = {
        "cell": spec.name,
        "setup_s": setup_s,
        "window": window,
        "facts": window["facts"],
        "trace": trace_rec,
    }
    metrics = {}
    for m in cell_metrics(spec.bench, spec.name, trace):
        value = load_metric(m["name"]).read(record)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result = {
        "correct": correct,
        "attempted": len(outcomes),
        "failed": failed,
        "metrics": metrics,
        "device": memory,
    }
    if trace:
        result["device"].update(busy_s=trace_rec["busy_s"], window_s=trace_rec["window_s"])
        result["breakdown"] = {"device_ops": trace_rec["device_ops"], "idle_gaps": trace_rec["idle_gaps"]}
    result["checks"] = {k: {"value": found[k], "limit": limit} for k, limit in limits.items()}
    return result, lines


def parse(argv):
    p = argparse.ArgumentParser(description="Run one cell of the port's benchmark.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv, t_start: float) -> int:
    args = parse(argv)
    spec = Spec(args.workload)
    card_or_exit(spec.cell["chips"])
    result, lines = run_cell(spec, args.seed, args.seconds, bool(args.trace), "cuda", t_start)
    bad = forbidden_modules()
    if bad:
        print(f"port_bench: the run loaded {', '.join(bad)}", file=sys.stderr)
        return 4
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0

