"""`spans.py`: the reduction of a trace with the program's spans, on a
synthetic timeline of three threads (the step's, the autograd engine's,
the batch worker's) with nested spans, a recompute launched from the
engine's thread inside `model.fusion`, host waits on two threads and idle
gaps with and without a runtime call under way; `trace.stop`'s record with
the span events present and removed; and the command's windows at tiny
widths on the CPU, where its recorder records the spans of both cells."""

from __future__ import annotations

import pytest
from torch.autograd import DeviceType

from port_bench import harness, spans, trace
from port_bench.tests import tiny

MAIN, ENGINE, WORKER = 11, 12, 13
SPANS = [  # name, thread, start, end (ns)
    ("step", MAIN, 0, 100),
    ("step.forward", MAIN, 1, 40),
    ("model.fusion", MAIN, 5, 15),
    ("step.backward", MAIN, 40, 80),
    ("model.fusion", ENGINE, 50, 60),  # checkpoint's recompute
    ("step.optimizer", MAIN, 80, 100),
    ("data.prepare", WORKER, 0, 95),
]
CALLS = [  # name, thread, start, end, correlation
    ("cudaLaunchKernel", MAIN, 6, 7, 1),
    ("cuLaunchKernel", MAIN, 6, 7, 1),  # a launch's driver call, recorded with the same correlation
    ("cudaMemcpyAsync", MAIN, 21, 22, 5),
    ("cudaStreamSynchronize", WORKER, 30, 31, 0),
    ("cudaLaunchKernel", ENGINE, 42, 43, 2),
    ("cudaLaunchKernel", ENGINE, 52, 53, 3),
    ("cudaLaunchKernel", MAIN, 85, 86, 4),
    ("cudaStreamSynchronize", MAIN, 91, 99, 0),
    ("cudaLaunchKernel", MAIN, 101, 102, 6),
    ("cudaLaunchKernel", MAIN, 113, 114, 7),
]
DEVICE = [  # name, start, end, correlation
    ("fusion_fwd", 10, 20, 1),
    ("Memcpy HtoD (Pinned -> Device)", 22, 24, 5),
    ("grad", 45, 50, 2),
    ("fusion_recompute", 55, 65, 3),
    ("adam", 87, 90, 4),
    ("outside_a", 110, 112, 6),
    ("outside_b", 120, 121, 7),
    ("no_launch_recorded", 122, 123, 8),
]


class Event:
    """A kineto event as `trace.stop` and `spans.split` read one."""

    def __init__(self, name, start, end, thread=0, corr=0, device=False, annotation=False):
        self._row = name, start, end, thread, corr, device, annotation

    def name(self):
        return self._row[0]

    def start_ns(self):
        return self._row[1]

    def end_ns(self):
        return self._row[2]

    def device_resource_id(self):
        return self._row[3]

    def correlation_id(self):
        return self._row[4]

    def device_type(self):
        return DeviceType.CUDA if self._row[5] else DeviceType.CPU

    def is_user_annotation(self):
        return self._row[6]


def events(with_spans=True):
    out = [Event(n, s, e, t, c) for n, t, s, e, c in CALLS] + [Event(n, s, e, 0, c, True) for n, s, e, c in DEVICE]
    if with_spans:
        out += [Event(n, s, e, t, annotation=True) for n, t, s, e in SPANS]
        out += [Event(n, s, e, 0, device=True, annotation=True) for n, t, s, e in SPANS]  # projected onto the card
    return out


class Stopped:
    """A finished profiler as `trace.stop` reads one."""

    def __init__(self, evs):
        self.profiler = self
        self.kineto_results = self
        self._evs = evs

    def events(self):
        return self._evs

    def __exit__(self, *exc):
        pass


NS = 1e-9
WINDOW = {"t0": 0.0, "t1": 1.0, "steps": 1}


@pytest.fixture(scope="module")
def table():
    return spans.reduce(*spans.split(events()))


def test_split_keeps_the_spans_apart():
    s, calls, dev = spans.split(events())
    assert s == SPANS and calls == CALLS and dev == DEVICE


@pytest.mark.parametrize("name, count, host, device, launches, waits, idle", [
    ("step", 1, 100, 28, 4, 1, 74),
    ("step.forward", 1, 39, 10, 1, 0, 27),
    ("step.backward", 1, 40, 15, 2, 0, 27),  # the engine thread's kernels, recompute included
    ("step.optimizer", 1, 20, 3, 1, 1, 20),
    ("model.fusion", 2, 20, 20, 2, 0, 9),
    ("data.prepare", 1, 95, 0, 0, 1, 0),  # the worker's wait, and nothing of the step's
])
def test_attribution(table, name, count, host, device, launches, waits, idle):
    row = table["spans"][name]
    assert row["count"] == count and row["launches"] == launches and row["waits"] == waits
    assert (row["host_s"], row["device_s"], row["idle_s"]) == pytest.approx((host * NS, device * NS, idle * NS))


def test_partition_recompute_and_coverage(table):
    t = table["spans"]
    parts = sum(t[n]["device_s"] for n in ("step.forward", "step.backward", "step.optimizer"))
    assert parts == pytest.approx(t["step"]["device_s"])
    assert table["recompute"] == {"device_s": pytest.approx(10 * NS), "launches": 1}
    assert table["kernel_s"] == pytest.approx(32 * NS) and table["covered_kernel_s"] == pytest.approx(28 * NS)
    assert table["unjoined_launches"] == 1
    assert table["threads"] == {"step": [MAIN], "running_the_step": [MAIN, ENGINE]}


def test_gap_names(table):
    assert table["idle_by_name"] == pytest.approx({
        "cudaLaunchKernel": 4 * NS,  # a runtime call under way keeps its name
        "step.forward": 23 * NS,
        "model.fusion": 5 * NS,  # the engine thread's span, innermost at the gap's start
        "step.backward": 22 * NS,
        "step.optimizer": 20 * NS,
        "(no host event)": 9 * NS,  # after the step: no call, no span
    })
    assert table["no_event_idle_share"] == pytest.approx(9 / 83)
    # trace.stop's names, where a gap had a runtime call, are kept
    old = dict(trace.stop(Stopped(events()), WINDOW)["idle_gaps"])
    assert old == pytest.approx({"cudaLaunchKernel": 4 * NS, "(no host event)": 79 * NS})
    renamed = sum(v for k, v in table["idle_by_name"].items() if k not in old)
    assert renamed + table["idle_by_name"]["(no host event)"] == pytest.approx(old["(no host event)"])


def test_wait_sites():
    """The program's two innermost calls where the trace has Python calls,
    else the three innermost operators; the innermost span beside them."""
    host = [("/x/safevla_tpu_torch/models/actor_critic.py(190): _fuse", 40, 60),
            ("/x/safevla_tpu_torch/ops/masks.py(10): f", 45, 55), ("torch/nn/modules/module.py(1): _call_impl", 46, 54),
            ("aten::to", 80, 90), ("aten::_to_copy", 81, 89), ("aten::copy_", 82, 88), ("aten::empty", 83, 84)]
    evs = [Event(n, s, e, MAIN) for n, s, e in host]
    evs += [Event(n, s, e, t, annotation=True) for n, t, s, e in SPANS if t == MAIN]
    evs += [Event("cudaStreamSynchronize", 50, 51, MAIN), Event("cudaStreamSynchronize", 52, 53, MAIN),
            Event("cudaStreamSynchronize", 85, 86, MAIN), Event("cudaStreamSynchronize", 50, 51, WORKER),
            Event("cudaLaunchKernel", 71, 72, MAIN)]
    assert spans.sites(evs) == {
        "cudaStreamSynchronize in safevla_tpu_torch/ops/masks.py(10): f"
        " <- safevla_tpu_torch/models/actor_critic.py(190): _fuse under step.backward": 2,
        "cudaStreamSynchronize in aten::copy_ <- aten::_to_copy <- aten::to under step.optimizer": 1,
        "cudaStreamSynchronize in (nothing recorded)": 1,
    }


def test_accepted_keys_are_the_same_with_or_without_spans():
    """Every key of trace.stop's record, which the accepted metrics read, is
    computed as before with the span events (host and projected) present."""
    assert trace.stop(Stopped(events(True)), WINDOW) == trace.stop(Stopped(events(False)), WINDOW)


@pytest.mark.parametrize("cell", [c["name"] for c in harness.benchmark()["workloads"]])
def test_command_windows_at_tiny_widths(cell):
    out = spans.main(["--workload", cell, "--seed", "4294967311", "--seconds", "0.2", "--sites", "1"],
                     spec=tiny.spec(cell), device="cpu")
    assert [w["kind"] for w in out["windows"]] == ["untraced", "trace", "spans", "spans", "trace", "untraced"]
    assert all(w["steps"] >= 1 for w in out["windows"]) and out["sites"]["steps"] == 1
    table = out["traces"]["spans"]["table"]["spans"]
    steps = out["traces"]["spans"]["steps"]
    want = {"step", "step.forward", "step.backward", "step.optimizer", "model.fusion"}
    want |= {"step.prepare"} if cell.startswith("update") else {"step.vision", "step.text", "data.prepare", "data.wait"}
    assert set(table) == want and table["step"]["count"] == steps
    parts = ("step.prepare",) if cell.startswith("update") else ("step.vision",)
    parts += ("step.forward", "step.backward", "step.optimizer")
    assert sum(table[p]["host_s"] for p in parts) <= table["step"]["host_s"]
