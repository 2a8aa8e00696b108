"""Profiling & step timing.

Copy of `safevla_tpu/utils/profiling.py`, in two layers:
  * `profile_trace(logdir)`: context manager around `torch.profiler` (the
    JAX one wraps the JAX profiler) — one call writes a Chrome trace of the
    host and, where CUDA is present, the card, viewable in Perfetto or
    chrome://tracing;
  * `StageTimer`: lightweight named-section wall timing with EMA summaries,
    for the per-stage breakdown (dispatch / action fetch / env step / ingest)
    that the rollout loop logs.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict, Iterator


@contextlib.contextmanager
def profile_trace(logdir: str, with_python: bool = False) -> Iterator[None]:
    """Trace the enclosed block into `logdir/trace_<pid>_<ns>.json` (Chrome
    trace format). `with_python` records the Python stacks of the host
    events (torch.profiler's `with_stack`)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    prof = profile(activities=activities, with_stack=with_python)
    prof.__enter__()
    try:
        yield
    finally:
        prof.__exit__(None, None, None)
        prof.export_chrome_trace(
            os.path.join(logdir, f"trace_{os.getpid()}_{time.time_ns()}.json")
        )


class StageTimer:
    def __init__(self, ema: float = 0.98):
        self.ema = ema
        self.means: Dict[str, float] = {}
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def section(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] += dt
            self.counts[name] += 1
            prev = self.means.get(name)
            self.means[name] = dt if prev is None else self.ema * prev + (1 - self.ema) * dt

    def summary(self, prefix: str = "time/") -> Dict[str, float]:
        return {f"{prefix}{k}": v for k, v in self.means.items()}

    def reset(self):
        self.means.clear()
        self.totals.clear()
        self.counts.clear()
