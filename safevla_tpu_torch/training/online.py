"""Online constrained-RL training loop.

Counterpart of `safevla_tpu/training/online.py`: `MetricAccumulator`, and
`OnlineTrainer` with `init_state`, the sync `train` and the async
`train_async`, which wire EnvPool -> RolloutRunner -> Learner with the
reference's 3-stage pipeline, checkpointing (a forced final save included)
and metric accumulation. `train` runs the config's pipeline: async by
default (`cfg.train.async_pipeline`, True as in JAX), sync when asked.

* Sync: each window is collected with the current weights and then learned
  from (exact same-window PPO).
* Async (stale-by-one): window k-1's update runs while window k is collected,
  as the chunk programs of `Learner.iter_chunked_update`, ceil(count / T) of
  them pumped after each env step; window k acts with the weights left by
  the updates of windows 0..k-2. The rollout acts with its own copy of the
  towers (`SafeVLAPolicy.acting_copy`), refreshed at each window boundary,
  since the learner steps its towers in place. On a CUDA device the update's
  programs run on a CUDA stream of their own and the acts on one of higher
  priority (`_Streams`; JAX gets the same order from its FIFO dispatch); on
  the CPU the same generator is pumped inline.

Data parallel (`mesh`, JAX's `mesh=`): one process per rank, each with a
pool of its own rows of the run's streams (`rollout/runner.py::
rank_stream_ids`, built by their global ids), the learner and the runner on
the mesh. Step counts, the async pump and logs count the global streams.
Only the primary rank writes checkpoints (`utils/checkpoint.py`) and calls
`log_fn`; every rank waits at a barrier after a save, so none runs ahead
of one, and a resume reads the same file on every rank. The wall-clock
stop is agreed by all ranks. `il_ckpt_path` imports a reference torch
checkpoint into the towers (`models/convert.py::load_reference_checkpoint`).
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from collections import defaultdict
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from safevla_tpu_torch.algo.learner import Learner, TrainState
from safevla_tpu_torch.config import Config
from safevla_tpu_torch.models.actor_critic import SafeVLAPolicy
from safevla_tpu_torch.models.convert import load_reference_checkpoint
from safevla_tpu_torch.parallel.distributed import is_primary_host
from safevla_tpu_torch.parallel.mesh import Mesh
from safevla_tpu_torch.rollout.env_pool import EnvPool
from safevla_tpu_torch.rollout.runner import OVERLAP_GROUPS, RolloutRunner, rank_stream_ids, stream_groups
from safevla_tpu_torch.utils.checkpoint import (
    latest_checkpoint,
    resolve_checkpoint_path,
    restore_checkpoint,
    save_checkpoint,
)


class MetricAccumulator:
    def __init__(self):
        self._sums = defaultdict(float)
        self._counts = defaultdict(int)

    def add(self, metrics: Dict[str, Any]):
        for k, v in metrics.items():
            if isinstance(v, (int, float, np.integer, np.floating)) and not isinstance(v, bool):
                self._sums[k] += float(v)
                self._counts[k] += 1
            elif isinstance(v, bool):
                self._sums[k] += float(v)
                self._counts[k] += 1

    def means(self) -> Dict[str, float]:
        return {k: self._sums[k] / max(self._counts[k], 1) for k in self._sums}

    def reset(self):
        self._sums.clear()
        self._counts.clear()


class _Streams:
    """The async pipeline's CUDA streams: `act` (high priority) for the
    rollout and everything around it, `update` (default priority) for the
    update's programs. On the CPU both contexts are no-ops and the programs
    run inline, in order.

    Hazards between the two streams, each handled where it arises in
    `train_async`:
      1. the update stream waits on an event recorded on the act stream after
         the window's batch is assembled (and the acting towers copied, 3);
      2. every batch tensor the update reads gets `record_stream(update)`: the
         caching allocator knows only a tensor's own stream, and would hand its
         memory to the act stream while the update still reads it;
      3. the copy of the learner's towers into the acting towers (on the act
         stream) waits on the update's last event; the next update writes them
         only after event 1, recorded after the copy;
      4. metrics read in `flush_log` wait on the update's last event first:
         `.item()` waits for the current (act) stream only;
      5. the rollout's device `torch.Generator` (the action draws) is used on
         the act stream only, in `RolloutRunner.collect`;
      6. nothing in the pump calls `torch.cuda.synchronize()`, which would
         make the pipeline serial again;
      7. both streams start after the work the caller enqueued on its stream
         (the runner's set-up, the restored weights), and the caller's stream
         waits on both before `train_async` returns.
    A failed launch on the update stream raises out of the pump; nothing
    catches it or falls back to sync mode."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        if self.cuda:
            # a lower number is a higher priority: the act's blocks take the
            # SMs first, as the act programs come first in JAX's FIFO
            self.act = torch.cuda.Stream(device, priority=-1)
            self.update = torch.cuda.Stream(device, priority=0)

    def acting(self):
        return torch.cuda.stream(self.act) if self.cuda else contextlib.nullcontext()

    def updating(self):
        return torch.cuda.stream(self.update) if self.cuda else contextlib.nullcontext()

    def event(self):
        """An event recorded on the current stream (None on the CPU)."""
        if not self.cuda:
            return None
        ev = torch.cuda.Event()
        ev.record()
        return ev


class OnlineTrainer:
    """Trains a policy built on `device` (on a mesh: the rank's device) with
    weights from a generator seeded with cfg.train.seed; the learner and
    the runner take the policy's device. With the async pipeline the runner
    acts with `act_policy`, a copy of the towers (sync: the policy itself).
    `pool_options` go to the env pool (e.g. `use_shm_frames=True` with
    `num_workers > 0`: camera frames through shared-memory rings)."""

    def __init__(
        self,
        cfg: Config,
        sampler_factory: Callable[[int], Any],
        num_workers: Optional[int] = None,
        log_fn: Optional[Callable[[Dict[str, Any], int], None]] = None,
        async_pipeline: Optional[bool] = None,
        device="cuda",
        mesh: Optional[Mesh] = None,
        pool_options: Optional[Dict[str, Any]] = None,
    ):
        self.cfg = cfg
        self.mesh = mesh
        # None = follow the config (async by default, as in JAX)
        self.async_pipeline = cfg.train.async_pipeline if async_pipeline is None else async_pipeline
        self.policy = SafeVLAPolicy(
            cfg.model, device=mesh.device if mesh is not None else device,
            generator=torch.Generator().manual_seed(cfg.train.seed),
        )
        self.learner = Learner(self.policy, cfg, mesh)
        self.num_streams = cfg.train.num_train_processes  # every rank's
        dp, dp_index = (mesh.dp, mesh.dp_index) if mesh is not None else (1, 0)
        n_groups, _ = stream_groups(self.num_streams, OVERLAP_GROUPS, dp)
        ids = rank_stream_ids(self.num_streams, n_groups, dp, dp_index)
        self.pool = EnvPool(
            sampler_factory, num_streams=len(ids), num_workers=num_workers, stream_ids=ids,
            **(pool_options or {}),
        )
        self.act_policy = self.policy.acting_copy() if self.async_pipeline else self.policy
        self.runner = RolloutRunner(self.act_policy, cfg, self.pool, seed=cfg.train.seed, mesh=mesh)
        self._streams: Optional[_Streams] = None  # made at the first async run
        self.log_fn = log_fn or self._default_log
        self.episode_accum = MetricAccumulator()
        self.output_dir = os.path.join(cfg.train.output_dir, cfg.train.tag)
        os.makedirs(self.output_dir, exist_ok=True)

    def _log(self, metrics: Dict[str, Any], step: int):
        if is_primary_host():
            self.log_fn(metrics, step)

    def _save(self, ts: TrainState, step: int, final: bool = False) -> None:
        """The checkpoint (written by the primary rank alone); on a mesh every
        rank waits here until it is on disk."""
        path = save_checkpoint(self.output_dir, ts, step)
        if self.mesh is not None:
            self.mesh.barrier()
        if is_primary_host():
            print(f"saved {'final ' if final else ''}checkpoint {path}")

    def _out_of_time(self, t_start: float, max_wall_seconds: Optional[float]) -> bool:
        """The wall-clock stop, the same on every rank."""
        late = bool(max_wall_seconds) and time.time() - t_start > max_wall_seconds
        return self.mesh.any(late) if self.mesh is not None and max_wall_seconds else late

    @staticmethod
    def _default_log(metrics: Dict[str, Any], step: int):
        printable = {k: (round(v, 4) if isinstance(v, float) else v) for k, v in metrics.items()}
        print(f"[step {step}] {json.dumps(printable, default=str)}", flush=True)

    # ------------------------------------------------------------------
    def init_state(self) -> TrainState:
        """A fresh TrainState over the policy's weights, restored from
        cfg.train.resume_ckpt_path when set, else with the towers of the
        reference checkpoint cfg.train.il_ckpt_path when set, else from the
        newest checkpoint in the output directory when there is one."""
        state = self.learner.init()
        if self.cfg.train.resume_ckpt_path:
            path = resolve_checkpoint_path(self.cfg.train.resume_ckpt_path)
            state = restore_checkpoint(path, state)
            print(f"resumed from {path}")
        elif self.cfg.train.il_ckpt_path:
            state = load_reference_checkpoint(
                resolve_checkpoint_path(self.cfg.train.il_ckpt_path), state, cfg=self.cfg
            )
        else:
            auto = latest_checkpoint(self.output_dir)
            if auto:
                state = restore_checkpoint(auto, state)
                print(f"auto-resumed from {auto}")
        return state

    # ------------------------------------------------------------------
    def train(
        self,
        total_steps: Optional[int] = None,
        train_state: Optional[TrainState] = None,
        max_wall_seconds: Optional[float] = None,
    ) -> TrainState:
        if self.async_pipeline:
            return self.train_async(total_steps, train_state, max_wall_seconds)
        cfg = self.cfg
        ts = train_state if train_state is not None else self.init_state()
        total = total_steps if total_steps is not None else cfg.train.total_steps
        last_save = int(ts.step)
        t_start = time.time()

        while int(ts.step) < total:
            step0 = int(ts.step)
            stage = self.learner.stage_for_step(step0)
            batch, roll_stats = self.runner.collect(cfg.ppo.num_steps)
            t_update = time.time()
            ts, metrics = self.learner.update(ts, batch, roll_stats["mean_episode_cost"], stage)
            metrics = {k: float(v) for k, v in metrics.items()}  # waits for the update
            update_seconds = time.time() - t_update

            for m in self.runner.pop_metrics():
                self.episode_accum.add(m)

            step_now = int(ts.step)
            log = {
                "stage": stage,
                **metrics,
                **roll_stats,
                "update_seconds": update_seconds,
                "total_fps": (step_now - step0) / max(time.time() - t_start, 1e-9)
                if step_now == step0 + cfg.ppo.num_steps * self.num_streams
                else None,
            }
            ep_means = self.episode_accum.means()
            if ep_means:
                log.update({f"ep/{k}": v for k, v in ep_means.items()})
            self._log({k: v for k, v in log.items() if v is not None}, step_now)

            if step_now - last_save >= cfg.train.save_interval:
                self._save(ts, step_now)
                last_save = step_now

            if self._out_of_time(t_start, max_wall_seconds):
                break
        # force a final save: a wall-clock or total-steps exit otherwise loses
        # up to save_interval steps of fully computed updates
        step_now = int(ts.step)
        if step_now > last_save:
            self._save(ts, step_now, final=True)
        return ts

    # ------------------------------------------------------------------
    def train_async(
        self,
        total_steps: Optional[int] = None,
        train_state: Optional[TrainState] = None,
        max_wall_seconds: Optional[float] = None,
    ) -> TrainState:
        """The async rollout/update pipeline (JAX `train_async`): while window
        k is collected, window k-1's update runs as its chunk programs, a
        few after each env step, and their weights apply one window late.

        As in JAX, the step count moves when an update finishes: the loop
        collects windows while fewer than `total` steps are learned, then the
        drain applies the update in flight, so the run ends one window past
        the first window boundary at or above `total`. Logs go one window
        late, with `"async": True`; `update_seconds` is the host's time in
        that update's programs. The learner steps the towers in place, so a
        checkpoint is written at the boundary where its update finished (the
        host waits for that update's last event, in the windows that save);
        the drained update is always saved."""
        if self.act_policy is self.policy:
            raise ValueError("train_async needs the trainer built with async_pipeline on")
        cfg = self.cfg
        ts = train_state if train_state is not None else self.init_state()
        total = total_steps if total_steps is not None else cfg.train.total_steps
        T, B = cfg.ppo.num_steps, self.num_streams
        # programs per env step, so that the whole update is enqueued in-window
        pump_k = max(1, -(-self.learner.chunked_program_count(B, T) // T))
        if self._streams is None:
            self._streams = _Streams(self.policy.device)
        streams = self._streams
        if streams.cuda:  # hazard 7: after the caller's work
            caller = torch.cuda.current_stream(self.policy.device)
            streams.act.wait_stream(caller)
            streams.update.wait_stream(caller)
        last_save = int(ts.step)
        t_start = time.time()
        # the step count and the metrics stay on the host's side of the
        # window boundary: reading them there would block the host behind the
        # update's device tail, so everything floats one window late
        step_now = int(ts.step)
        prev = None  # {"it", "stage", "done", "seconds", "result"} of the update in flight
        pending_log = None  # (update, roll stats, step) to log at the next boundary

        def pump(upd) -> None:
            """Enqueue the update's next program on the update stream."""
            t0 = time.perf_counter()
            with streams.updating():
                try:
                    next(upd["it"])
                except StopIteration as stop:
                    upd["result"] = stop.value
                    upd["done"] = streams.event()  # after its last program
            upd["seconds"] += time.perf_counter() - t0

        def flush_log() -> None:
            nonlocal pending_log
            if pending_log is None:
                return
            upd, stats, step = pending_log
            pending_log = None
            if upd["done"] is not None:  # hazard 4: the metrics were made on the update stream
                upd["done"].synchronize()
            metrics = {k: float(v) for k, v in upd["result"][1].items()}
            log = {"stage": upd["stage"], "async": True, **metrics, **stats,
                   "update_seconds": upd["seconds"]}
            for m in self.runner.pop_metrics():
                self.episode_accum.add(m)
            log.update({f"ep/{k}": v for k, v in self.episode_accum.means().items()})
            log["total_fps"] = step / max(time.time() - t_start, 1e-9)
            self._log(log, step)

        def save(upd, step: int) -> None:
            nonlocal last_save
            if upd["done"] is not None:  # the weights are the update's once it has run
                upd["done"].synchronize()
            self._save(ts, step)
            last_save = step

        def finish(upd) -> TrainState:
            """The update's remaining programs enqueued; its state."""
            while "result" not in upd:
                pump(upd)
            return upd["result"][0]

        with streams.acting():
            # the rollout acts with the learner's weights as they start
            self.act_policy.load_towers(self.policy)
            while step_now < total:
                stage = self.learner.stage_for_step(step_now)

                def interleave(t, upd=prev):
                    for _ in range(pump_k):
                        if upd is None or "result" in upd:
                            break
                        pump(upd)

                batch, roll_stats = self.runner.collect(T, interleave_fn=interleave)
                if prev is not None:
                    ts = finish(prev)  # the undispatched programs of window k-1's update
                    flush_log()  # window k-2's update
                    if streams.cuda:  # hazard 3: the copy reads the update's weights
                        streams.act.wait_event(prev["done"])
                    self.act_policy.load_towers(self.policy)
                    step_now += B * T
                    pending_log = (prev, roll_stats, step_now)
                    if step_now - last_save >= cfg.train.save_interval:
                        save(prev, step_now)
                # the window just collected: its update (with ITS stage) runs
                # while the next window is collected
                if streams.cuda:
                    for v in batch.values():  # hazard 2
                        v.record_stream(streams.update)
                    # hazard 1: after the batch and the tower copy, on the act stream
                    streams.update.wait_event(streams.event())
                prev = {
                    "it": self.learner.iter_chunked_update(
                        ts, batch, roll_stats["mean_episode_cost"], stage
                    ),
                    "stage": stage, "done": None, "seconds": 0.0,
                }
                if self._out_of_time(t_start, max_wall_seconds):
                    break
            # drain: the update in flight is applied, so the returned state
            # has learned from every collected window, and saved
            if prev is not None:
                ts = finish(prev)
                flush_log()
                step_now += B * T
                pending_log = (prev, roll_stats, step_now)
                flush_log()
                if step_now > last_save:
                    save(prev, step_now)
        if streams.cuda:  # hazard 7: the caller's stream after both
            caller.wait_stream(streams.act)
            caller.wait_stream(streams.update)
        return ts

    def close(self):
        self.pool.close()
