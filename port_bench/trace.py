"""The traced run's reduction: torch.profiler over the window, read into
what the per-layer metrics and the result's `breakdown` need. On the card
the profiler records the device's activity and the CUDA runtime calls
(CUPTI) and not every host operator, which would slow the host-bound steps
it measures; on the CPU (the tests) it records the host's operators.

    busy_s       the union of the device's activity intervals in the trace
                 (two streams that overlap count once)
    window_s     the window's length on the host's clock
    steps        the window's steps begun
    kernel_s     device seconds by kernel name (copies and sets left out)
    kernels      kernel activities in the window: one per launch
    host_syncs   CUDA runtime calls that make the host wait for the card,
                 less the window's own two
    device_ops   the ten kernels of most device time
    idle_gaps    the device's idle time, by the host event (a runtime call)
                 under way when each gap began, the ten largest; "(no host
                 event)" where the host ran Python or the framework
"""

from __future__ import annotations

import bisect
from collections import defaultdict

HOST_WAITS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize", "cudaMemcpy")
NOT_KERNELS = ("Memcpy", "Memset")
OWN_SYNCS = 2  # a driver's window synchronises once before its clock starts and once at its end


def start(device):
    import torch
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.device(device).type == "cuda"
    prof = profile(activities=[ProfilerActivity.CUDA if cuda else ProfilerActivity.CPU])
    prof.__enter__()
    return prof


def union(intervals):
    """Sorted, merged (start, end) pairs."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


def stop(prof, window: dict) -> dict:
    from torch.autograd import DeviceType

    prof.__exit__(None, None, None)
    host, dev = [], []
    for e in prof.profiler.kineto_results.events():
        if e.is_user_annotation():
            continue
        (host if e.device_type() == DeviceType.CPU else dev).append((e.start_ns(), e.end_ns(), e.name()))
    times = [t for ev in host + dev for t in ev[:2]]
    w0, w1 = (min(times), max(times)) if times else (0, 0)
    busy = union((s, e) for s, e, _ in dev)
    busy_ns = sum(e - s for s, e in busy)
    kernel_s = defaultdict(float)
    kernels = 0
    for s, e, n in dev:
        if not n.startswith(NOT_KERNELS):
            kernel_s[n] += (e - s) / 1e9
            kernels += 1
    host_syncs = sum(1 for s, e, n in host if n in HOST_WAITS) - OWN_SYNCS
    # idle gaps inside the window, named by the innermost host event under way at their start
    host.sort()
    starts = [h[0] for h in host]
    edges = [w0] + [t for iv in busy for t in iv] + [w1]
    idle = defaultdict(float)
    for g0, g1 in zip(edges[0::2], edges[1::2]):
        if g1 <= g0:
            continue
        i = bisect.bisect_right(starts, g0) - 1
        name = "(no host event)"
        for j in range(i, max(i - 200, -1), -1):
            if host[j][1] > g0:
                name = host[j][2]
                break
        idle[name] += (g1 - g0) / 1e9
    top = lambda d: [[k[:160], v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]
    return {
        "busy_s": busy_ns / 1e9,
        "window_s": window["t1"] - window["t0"],
        "steps": window["steps"],
        "kernel_s": dict(kernel_s),
        "kernels": kernels,
        "host_syncs": max(host_syncs, 0),
        "device_ops": top(kernel_s),
        "idle_gaps": top(idle),
    }
