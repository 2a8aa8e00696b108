"""Online constrained-RL training loop, synchronous.

Counterpart of `safevla_tpu/training/online.py`: `MetricAccumulator`, and
`OnlineTrainer` with `init_state` and the sync `train`, which wires EnvPool
-> RolloutRunner -> Learner with the reference's 3-stage pipeline,
checkpointing (a forced final save included) and metric accumulation. Each
window is collected with the current weights and then learned from (exact
same-window PPO).

The JAX package's default is its async pipeline (window k-1's update woven
between window k's acts); it is not ported yet, so asking for it (the
config default `cfg.train.async_pipeline=True`, or `async_pipeline=True`)
raises NotImplementedError: pass `async_pipeline=False`. Multi-device meshes
are not ported yet either. `il_ckpt_path` imports a reference torch
checkpoint into the towers (`models/convert.py::load_reference_checkpoint`).
"""

from __future__ import annotations

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
from safevla_tpu_torch.rollout.env_pool import EnvPool
from safevla_tpu_torch.rollout.runner import RolloutRunner
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


class OnlineTrainer:
    """Trains a policy built on `device` with weights from a generator
    seeded with cfg.train.seed; the learner and the runner take the
    policy's device."""

    def __init__(
        self,
        cfg: Config,
        sampler_factory: Callable[[int], Any],
        num_workers: Optional[int] = None,
        log_fn: Optional[Callable[[Dict[str, Any], int], None]] = None,
        async_pipeline: Optional[bool] = None,
        device="cuda",
    ):
        self.cfg = cfg
        self.async_pipeline = cfg.train.async_pipeline if async_pipeline is None else async_pipeline
        if self.async_pipeline:
            raise NotImplementedError(
                "the async rollout/update pipeline is not ported yet; pass "
                "async_pipeline=False (or set cfg.train.async_pipeline = False)"
            )
        self.policy = SafeVLAPolicy(
            cfg.model, device=device, generator=torch.Generator().manual_seed(cfg.train.seed)
        )
        self.learner = Learner(self.policy, cfg)
        self.pool = EnvPool(
            sampler_factory, num_streams=cfg.train.num_train_processes, num_workers=num_workers
        )
        self.runner = RolloutRunner(self.policy, cfg, self.pool, seed=cfg.train.seed)
        self.log_fn = log_fn or self._default_log
        self.episode_accum = MetricAccumulator()
        self.output_dir = os.path.join(cfg.train.output_dir, cfg.train.tag)
        os.makedirs(self.output_dir, exist_ok=True)

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
                if step_now == step0 + cfg.ppo.num_steps * self.pool.num_streams
                else None,
            }
            ep_means = self.episode_accum.means()
            if ep_means:
                log.update({f"ep/{k}": v for k, v in ep_means.items()})
            self.log_fn({k: v for k, v in log.items() if v is not None}, step_now)

            if step_now - last_save >= cfg.train.save_interval:
                path = save_checkpoint(self.output_dir, ts, step_now)
                last_save = step_now
                print(f"saved checkpoint {path}")

            if max_wall_seconds and time.time() - t_start > max_wall_seconds:
                break
        # force a final save: a wall-clock or total-steps exit otherwise loses
        # up to save_interval steps of fully computed updates
        step_now = int(ts.step)
        if step_now > last_save:
            path = save_checkpoint(self.output_dir, ts, step_now)
            print(f"saved final checkpoint {path}")
        return ts

    def close(self):
        self.pool.close()
