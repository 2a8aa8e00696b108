"""Profiling & step timing.

Copy of `safevla_tpu/utils/profiling.py`, in three layers:
  * `span(name)`: a named range of the program, recorded by `torch.profiler`
    when one is running (on its clock, the one the card's activity is put
    on) and a shared no-op context otherwise (one check, no
    `record_function`);
  * `profile_trace(logdir)`: context manager around `torch.profiler` (the
    JAX one wraps the JAX profiler) — one call writes a Chrome trace of the
    host, every thread of the process and, where CUDA is present, the card,
    viewable in Perfetto or chrome://tracing, with the program's spans as
    user annotations;
  * `StageTimer`: lightweight named-section wall timing with EMA summaries
    and per-window totals, for the per-stage breakdown (dispatch / action
    fetch / env step / ingest) that the rollout loop logs; each section is
    also a span, `rollout.<name>`.

The spans the program records (`step.*` partition `step`):

    step            Learner.update; OfflineTrainer._bc_step
    step.prepare    Learner._prepare: dual GAE, advantage normalisation,
                    the lambda ascent (the chunked update's too)
    step.forward    each epoch's loss forward; BC: the towers' forward_seq
                    and the masked loss after the frozen ViT
    step.backward   torch.autograd.grad and the zero-fill of the gradients
                    (BC: and the gradients' all-reduce)
    step.optimizer  Learner._apply (all-reduce, clip, Adam); BC: the
                    gradient norm and AdamW
    step.vision     BC: uint8 -> f32, augmentation, normalisation, the
                    frozen ViT (outside autograd)
    step.text       OfflineTrainer.attach_text: the uploads and the frozen
                    text tower (before `step`)
    model.fusion    PolicyTower.embed_obs, each chunk of an eager fusion
                    pass (inside step.backward: the recompute, on the
                    autograd engine's thread on the card); a replayed
                    forward pass of a tower's fusion (models/fusion_pass.py)
    model.fusion_grad  a replayed backward pass of a tower's fusion: every
                    chunk's recompute and gradient, one CUDA graph
    data.prepare    OfflineTrainer.host_prepare, on the batch worker thread
    data.wait       the consumer's wait for a prepared batch
    rollout.<name>  each StageTimer section of the rollout runner

An operator records them with `profile_trace`; a run may instead enable the
profiler's CPU activity for user scopes alone
(`RecordScope.USER_SCOPE`), which records the spans and no host operator.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import ContextManager, Dict, Iterator

import torch
import torch.autograd.profiler as _autograd_profiler

_NO_SPAN = contextlib.nullcontext()


def span(name: str) -> ContextManager:
    """`torch.profiler.record_function(name)` while a profiler runs, else a
    shared no-op context. The profiler's own flag is per thread and is not
    set on a thread the program starts itself (the batch worker), so the
    process-wide flag that `torch.profiler.profile` sets on entry is read
    first."""
    if _autograd_profiler._is_profiler_enabled or torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _NO_SPAN


@contextlib.contextmanager
def profile_trace(logdir: str, with_python: bool = False) -> Iterator[None]:
    """Trace the enclosed block into `logdir/trace_<pid>_<ns>.json` (Chrome
    trace format). `with_python` records the Python stacks of the host
    events (torch.profiler's `with_stack`)."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    prof = profile(
        activities=activities,
        with_stack=with_python,
        experimental_config=torch._C._profiler._ExperimentalConfig(profile_all_threads=True),
    )
    prof.__enter__()
    try:
        yield
    finally:
        prof.__exit__(None, None, None)
        prof.export_chrome_trace(
            os.path.join(logdir, f"trace_{os.getpid()}_{time.time_ns()}.json")
        )


class StageTimer:
    """Named wall sections: an EMA of each section's seconds (`summary`),
    running totals and counts, and each section's seconds since the last
    `window_totals` call. Each section runs inside `span("rollout." + name)`
    (the rollout runner's sections)."""

    def __init__(self, ema: float = 0.98):
        self.ema = ema
        self.means: Dict[str, float] = {}
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)
        self._marked: Dict[str, float] = {}

    @contextlib.contextmanager
    def section(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            with span("rollout." + name):
                yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] += dt
            self.counts[name] += 1
            prev = self.means.get(name)
            self.means[name] = dt if prev is None else self.ema * prev + (1 - self.ema) * dt

    def summary(self, prefix: str = "time/") -> Dict[str, float]:
        return {f"{prefix}{k}": v for k, v in self.means.items()}

    def window_totals(self) -> Dict[str, float]:
        """`time_total/<section>`: each section's seconds since the previous
        call (all of them on the first), a window's totals where the EMA
        smooths across windows."""
        out = {f"time_total/{k}": v - self._marked.get(k, 0.0) for k, v in self.totals.items()}
        self._marked = dict(self.totals)
        return out

    def reset(self):
        self.means.clear()
        self.totals.clear()
        self.counts.clear()
        self._marked.clear()
