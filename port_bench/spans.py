"""The program's spans in a traced window (`safevla_tpu_torch/utils/profiling.py::span`):
a recorder that adds them to what `trace.py` records, and the reduction of
such a trace into a table by span.

    python3 port_bench/spans.py --workload <cell> --seed <n> [--seconds 10] [--sites 0|1]

`Recorder` enables the profiler as `trace.start` does (the card's activity
and the CUDA runtime calls) and, besides, the CPU activity of every thread
restricted to user scopes: the spans, and not one host operator. `trace.stop`
reads it as it reads `trace.start`'s profiler; every key it computes is the
same with the span events present, since it leaves user annotations out.

`reduce` puts each kernel, host wait and idle gap under the spans under
way when it began:

    nesting     a runtime call's spans are those of its own thread; a thread
                that runs the step without opening `step` (the autograd
                engine's device thread) has the spans of the thread that
                opened `step` beneath its own, so checkpoint's recompute is
                `model.fusion` inside `step.backward`; any other thread (the
                batch worker) has its own alone
    kernels     joined to the runtime call that launched them by correlation
                id; copies and sets left out, as in `trace.kernel_s`
    waits       the `trace.HOST_WAITS` calls begun inside the span
    idle        each gap in the device's activity, by the spans under way at
                its start on the threads that run the step; a gap that began
                in a runtime call keeps that call's name, as `trace.stop`
                names it, and one that began in neither keeps "(no host event)"

Per span: count, host seconds (summed durations), device seconds and
launches, waits, idle seconds; each inclusive of the spans inside it.
`recompute` is the kernels launched inside `model.fusion` while
`step.backward` was under way. `covered_kernel_s` is the kernel time
launched inside `step`, `step.text` or a `data.*` span, of `kernel_s`, every
kernel's; `unjoined_launches` counts the kernels whose launching call the
trace lacks (uncovered).

The command runs the cell's `Driver` (`drivers/<name>.py`) as
`harness.run_cell` does (set-up from the seed), then windows in one process:
untraced, traced as `trace.start` traces, traced by `Recorder`, each twice
(U T S S T U), and prints one JSON line: each window's seconds a step, both
traces' accepted keys, and the span table. `--sites 1` adds one step under
the full profiler with Python stacks and counts the host waits by where
they began (`sites`).
"""

from __future__ import annotations

import argparse
import bisect
import json
import sys
import time
from collections import Counter, defaultdict
from pathlib import Path

if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    # importing the command sets the benchmark's environment (threads, caches)
    from port_bench import run  # noqa: F401

from port_bench import trace  # noqa: E402

ROOTS = ("step", "step.text", "data.")  # spans whose kernels count as covered
NO_EVENT = "(no host event)"
PROGRAM = "safevla_tpu_torch/"  # the program's Python calls, by their file


class Recorder:
    """A profiler session of the card, the runtime calls and the spans,
    entered on construction; `trace.stop` ends and reads it."""

    def __init__(self, device):
        import torch
        import torch.autograd.profiler as autograd_profiler
        from torch._C._profiler import ProfilerActivity, RecordScope

        self.cuda = torch.device(device).type == "cuda"
        acts = {ProfilerActivity.CPU} | ({ProfilerActivity.CUDA} if self.cuda else set())
        session = autograd_profiler.profile(
            use_kineto=True, use_device="cuda" if self.cuda else None,
            experimental_config=torch._C._profiler._ExperimentalConfig(profile_all_threads=True),
        )
        config = session.config()
        torch.autograd._prepare_profiler(config, acts)
        autograd_profiler._run_on_profiler_start()  # the process-wide flag the spans read
        torch.autograd._enable_profiler(config, acts, {RecordScope.USER_SCOPE})
        self.profiler = self  # trace.stop reads `prof.profiler.kineto_results`
        self.kineto_results = None

    def __exit__(self, *exc):
        import torch
        import torch.autograd.profiler as autograd_profiler

        if self.cuda:
            torch.cuda.synchronize()
        self.kineto_results = torch.autograd._disable_profiler()
        autograd_profiler._run_on_profiler_stop()


def split(events):
    """Kineto events -> (spans (name, thread, start, end), runtime and other
    host calls (name, thread, start, end, correlation), device activities
    (name, start, end, correlation))."""
    from torch.autograd import DeviceType

    spans, calls, dev = [], [], []
    for e in events:
        if e.device_type() == DeviceType.CPU:
            row = (e.name(), e.device_resource_id(), e.start_ns(), e.end_ns())
            if e.is_user_annotation():
                spans.append(row)
            else:
                calls.append(row + (e.correlation_id(),))
        elif not e.is_user_annotation():
            dev.append((e.name(), e.start_ns(), e.end_ns(), e.correlation_id()))
    return spans, calls, dev


class Timeline:
    """The spans under way on each thread at a time: a change point at each
    start and end, the stack (span indices, outermost first) after it."""

    def __init__(self, spans):
        self.spans = spans
        by_thread = defaultdict(list)
        for i, s in enumerate(spans):
            by_thread[s[1]].append(i)
        self.points = {}
        for tid, ids in by_thread.items():
            ids.sort(key=lambda i: (spans[i][2], -spans[i][3]))
            times, stacks, stack = [], [], []

            def mark(t):
                if times and times[-1] == t:
                    stacks[-1] = tuple(stack)
                else:
                    times.append(t)
                    stacks.append(tuple(stack))

            for i in ids:
                while stack and spans[stack[-1]][3] <= spans[i][2]:
                    mark(spans[stack.pop()][3])
                stack.append(i)
                mark(spans[i][2])
            while stack:
                mark(spans[stack.pop()][3])
            self.points[tid] = (times, stacks)

    def at(self, tid, t):
        times, stacks = self.points.get(tid, ((), ()))
        i = bisect.bisect_right(times, t) - 1
        return stacks[i] if i >= 0 else ()


def reduce(spans, calls, dev) -> dict:
    """The span table of one trace (see the module's docstring)."""
    tl = Timeline(spans)
    names = [s[0] for s in spans]
    steps = [s for s in spans if s[0] == "step"]
    step_threads = sorted({s[1] for s in steps})
    step_iv = trace.union((s[2], s[3]) for s in steps)
    step_starts = [iv[0] for iv in step_iv]

    def in_step(t):
        i = bisect.bisect_right(step_starts, t) - 1
        return i >= 0 and t < step_iv[i][1]

    kernels = {c: (n, s, e) for n, s, e, c in dev if not n.startswith(trace.NOT_KERNELS)}
    runners = set(step_threads) | {tid for n, tid, s, e, c in calls if c in kernels and in_step(s)}

    def stack(tid, t):
        own = tl.at(tid, t)
        if tid in runners and tid not in step_threads:
            return tuple(i for st in step_threads for i in tl.at(st, t)) + own
        return own

    table = {n: {"count": 0, "host_s": 0.0, "device_s": 0.0, "launches": 0, "waits": 0, "idle_s": 0.0}
             for n in sorted(set(names))}
    for n, tid, s, e in spans:
        table[n]["count"] += 1
        table[n]["host_s"] += (e - s) / 1e9
    # a kernel's first host call (a runtime launch may record its CUDA driver API call too)
    launcher = {}
    for n, tid, s, e, c in calls:
        if c in kernels:
            launcher.setdefault(c, (tid, s))
        if n in trace.HOST_WAITS:
            for i in set(stack(tid, s)):
                table[names[i]]["waits"] += 1
    recompute = {"device_s": 0.0, "launches": 0}
    kernel_s = sum(e - s for n, s, e in kernels.values()) / 1e9
    covered = 0.0
    for c, (tid, s) in launcher.items():
        n, k0, k1 = kernels[c]
        d = (k1 - k0) / 1e9
        under = {names[i] for i in stack(tid, s)}
        for name in under:
            table[name]["device_s"] += d
            table[name]["launches"] += 1
        if {"model.fusion", "step.backward"} <= under:
            recompute["device_s"] += d
            recompute["launches"] += 1
        if any(name.startswith(ROOTS) for name in under):
            covered += d

    # idle gaps, named as trace.stop names them, then by the innermost span
    host = sorted((s, e, n) for n, tid, s, e, c in calls)
    times = [t for ev in host for t in ev[:2]] + [t for _, s, e, _ in dev for t in (s, e)]
    w0, w1 = (min(times), max(times)) if times else (0, 0)
    busy = trace.union((s, e) for _, s, e, _ in dev)
    starts = [h[0] for h in host]
    edges = [w0] + [t for iv in busy for t in iv] + [w1]
    idle = defaultdict(float)
    for g0, g1 in zip(edges[0::2], edges[1::2]):
        if g1 <= g0:
            continue
        gap = (g1 - g0) / 1e9
        i = bisect.bisect_right(starts, g0) - 1
        name = None
        for j in range(i, max(i - 200, -1), -1):
            if host[j][1] > g0:
                name = host[j][2]
                break
        under = {k for tid in runners for k in stack(tid, g0)}
        for k in {names[k] for k in under}:
            table[k]["idle_s"] += gap
        if name is None and under:
            name = names[max(under, key=lambda k: spans[k][2])]
        idle[name or NO_EVENT] += gap
    total_idle = sum(idle.values())
    return {
        "spans": table,
        "recompute": recompute,
        "kernel_s": kernel_s,
        "covered_kernel_s": covered,
        "unjoined_launches": len(kernels) - len(launcher),
        "idle_s": total_idle,
        "idle_by_name": dict(sorted(idle.items(), key=lambda kv: -kv[1])),
        "no_event_idle_share": idle.get(NO_EVENT, 0.0) / total_idle if total_idle else None,
        "threads": {"step": step_threads, "running_the_step": sorted(runners)},
    }


def sites(events) -> dict:
    """Host waits of a trace recorded with every host operator -> {"<wait>
    in <where> under <span>": count}: where is the program's two innermost
    Python calls under way on the wait's thread (`with_stack` records them
    as host events "<file>(<line>): <function>" where the torch build does),
    else its three innermost operators; span, the innermost span."""
    from torch.autograd import DeviceType

    host = defaultdict(list)
    waits = []
    for e in events:
        if e.device_type() != DeviceType.CPU:
            continue
        row = (e.start_ns(), e.end_ns(), e.name(), e.is_user_annotation())
        (waits.append((e.device_resource_id(), row)) if e.name() in trace.HOST_WAITS
         else host[e.device_resource_id()].append(row))
    out = Counter()
    for tid, (t, _, name, _) in waits:
        under = sorted((s, n, span) for s, e, n, span in host[tid] if s <= t < e)
        calls = [n[n.find(PROGRAM):] for _, n, span in under if PROGRAM in n and not span]
        ops = [n for _, n, span in under if not span and ".py(" not in n]
        named = [n for _, n, span in under if span]
        where = " <- ".join((calls[::-1][:2] if calls else ops[::-1][:3])) or "(nothing recorded)"
        out[f"{name} in {where}" + (f" under {named[-1]}" if named else "")] += 1
    return dict(out.most_common())


def parse(argv):
    p = argparse.ArgumentParser(description="The program's spans in a cell's traced windows.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=10.0)
    p.add_argument("--sites", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv, spec=None, device="cuda") -> dict:
    """One process: set-up, then windows U T S S T U (and the sites'); the
    result as a dict (printed as one JSON line by the command). `spec` and
    `device`, for the tests: a tiny cell on the CPU."""
    import torch

    from port_bench import harness

    args = parse(argv)
    spec = spec or harness.Spec(args.workload)
    if device == "cuda":
        harness.card_or_exit(spec.cell["chips"])
    driver = harness.load_module("drivers", spec.traffic["driver"]).Driver(spec, args.seed, device)
    driver.setup()
    harness.synchronize(device)
    out = {"cell": spec.name, "device": harness.device_info(device)["kind"], "windows": [], "traces": {}}

    def per_step(w):
        return (w["t1"] - w["t0"]) / w["steps"] if w["steps"] else None

    for kind in "UTSSTU":
        if kind == "U":
            w = driver.window(args.seconds)
            out["windows"].append({"kind": "untraced", "step_s": per_step(w), "steps": w["steps"]})
            continue
        rec = trace.start(device) if kind == "T" else Recorder(device)
        w = driver.window(args.seconds)
        t0 = time.perf_counter()
        record = trace.stop(rec, w)
        table = reduce(*split(rec.kineto_results.events())) if kind == "S" else None
        name = "trace" if kind == "T" else "spans"
        out["windows"].append({"kind": name, "step_s": per_step(w), "steps": w["steps"],
                               "reduction_s": time.perf_counter() - t0})
        if name not in out["traces"]:
            keep = ("busy_s", "window_s", "steps", "kernels", "host_syncs", "idle_gaps")
            out["traces"][name] = {k: record[k] for k in keep}
            if table is not None:
                out["traces"][name]["table"] = table
    if args.sites:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device == "cuda" else [])
        with profile(activities=acts, with_stack=True) as prof:
            w = driver.window(1e-3)  # one step
        out["sites"] = {"steps": w["steps"], "waits": sites(prof.profiler.kineto_results.events())}
    driver.free()
    if device == "cuda":
        torch.cuda.empty_cache()
    return out


if __name__ == "__main__":
    print(json.dumps(main(sys.argv[1:])), flush=True)
