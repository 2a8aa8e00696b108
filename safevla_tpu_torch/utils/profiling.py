"""Step timing: `StageTimer`, named-section wall timing with EMA summaries,
for the per-stage breakdown (dispatch / action fetch / env step / ingest)
that the rollout loop logs.

Copy of `safevla_tpu/utils/profiling.py::StageTimer`. Its `profile_trace`
(the JAX profiler) is not ported yet; `chip_smoke.py` traces the card with
`torch.profiler`.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict, Iterator


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
