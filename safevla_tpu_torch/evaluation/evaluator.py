"""Batched evaluator: benchmark episodes -> queue -> env pool -> batched agent.

Counterpart of `safevla_tpu/evaluation/evaluator.py` (reference
online_evaluation/online_evaluator.py:198-795 + online_evaluator_worker.py:
53-701), the same loop: the simulators run in the env pool (processes, or
inline), the agent acts once per step for all streams on the card, and
episodes are pulled from a shared spec queue until it is empty. Output
(per-episode safety table, per-metric aggregation, per-object-type
breakdown) matches the reference's tables.
"""

from __future__ import annotations

import queue as _queue
import time
from collections import defaultdict
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from safevla_tpu_torch.config import Config
from safevla_tpu_torch.constants import ALL_STRETCH_ACTIONS
from safevla_tpu_torch.evaluation.agent import InferenceAgent
from safevla_tpu_torch.evaluation.types import (
    MAX_EPISODE_LEN_PER_TASK,
    eval_sample_to_normalized_eval_sample,
)
from safevla_tpu_torch.rollout.env_pool import EnvPool
from safevla_tpu_torch.utils.video import EpisodeVideoRecorder, save_image


class MetricAggregator:
    """Mean aggregation (reference online_evaluator.py:83-104)."""

    def __init__(self):
        self.sample_metrics: List[float] = []

    def update(self, metric: float):
        self.sample_metrics.append(metric)

    def aggregate(self) -> float:
        return sum(self.sample_metrics) / (len(self.sample_metrics) + 1e-10)

    def size(self) -> int:
        return len(self.sample_metrics)


SAFETY_TABLE_COLUMNS = [
    "sample_id", "success", "sel", "spl", "ep_length",
    "cost", "cost_corner", "cost_danger", "cost_blind",
    "cost_fragile", "cost_critical",
]


class BatchedEvaluator:
    def __init__(
        self,
        cfg: Config,
        sampler_factory_builder: Callable[[Any], Callable[[int], Any]],
        num_streams: Optional[int] = None,
        num_workers: int = 0,
        max_eval_tasks: Optional[int] = None,
        video_dir: Optional[str] = None,
        video_every: int = 0,
        max_episode_len: Optional[int] = None,
    ):
        """`sampler_factory_builder(tasks_queue) -> sampler_factory(stream_id)`
        must build samplers whose task_spec_sampler drains `tasks_queue`.
        `video_every=N` records every Nth episode of stream 0 as an annotated
        video into `video_dir` (reference online_evaluator_worker.py:637-696)."""
        self.cfg = cfg
        self.num_streams = num_streams or cfg.eval.num_workers
        self.num_workers = num_workers
        self.sampler_factory_builder = sampler_factory_builder
        self.max_eval_tasks = max_eval_tasks or cfg.eval.max_eval_tasks
        self.video_dir = video_dir
        self.video_every = video_every if video_dir else 0
        # None -> the benchmark protocol's per-task-type cap; set explicitly
        # when the samplers enforce a shorter task max_steps (tests)
        self.max_episode_len = max_episode_len

    # ------------------------------------------------------------------
    def evaluate(
        self,
        agent: InferenceAgent,
        eval_samples: List[Dict[str, Any]],
        task_type: str,
        progress_every: int = 50,
    ) -> Dict[str, Any]:
        samples = eval_samples[: self.max_eval_tasks] if self.max_eval_tasks else eval_samples
        normalized = [
            eval_sample_to_normalized_eval_sample(task_type, s, i)
            for i, s in enumerate(samples)
        ]
        tasks_queue: _queue.Queue = _queue.Queue()
        for s in normalized:
            tasks_queue.put(s)
        total = len(normalized)

        factory = self.sampler_factory_builder(tasks_queue)
        pool = EnvPool(factory, num_streams=self.num_streams, num_workers=self.num_workers)

        active = np.array([s is not None for s in pool.initial_steps()])
        steps = pool.initial_steps()
        max_len = self.max_episode_len or MAX_EPISODE_LEN_PER_TASK.get(task_type, 600)
        if agent.cfg.model.max_steps < max_len:
            pool.close()
            raise ValueError(
                f"agent KV cache covers {agent.cfg.model.max_steps} steps but "
                f"{task_type} eval episodes run up to {max_len} — build the "
                f"agent with max_episode_steps={max_len} (the decode position "
                "would silently wrap mid-episode)"
            )

        agent.set_instructions(
            [s.instruction if s else "" for s in steps]
        )
        all_metrics: List[Dict[str, Any]] = []
        t0 = time.time()
        episode_steps = np.zeros(self.num_streams, np.int64)

        recorder = None
        episodes_on_stream0 = 0
        if self.video_every:
            recorder = EpisodeVideoRecorder(self.video_dir)

        while active.any():
            obs = [s.obs if s is not None and s.obs is not None else None for s in steps]
            # streams that are done keep replaying a zero frame (masked out);
            # if EVERY still-active stream came back obs=None in the same step
            # (all task queues drained at once), exit cleanly instead of
            # crashing on an empty generator
            ref = next((o for o in obs if o is not None), None)
            if ref is None:
                break
            rgb_nav = np.stack(
                [o["rgb_raw"] if o is not None else np.zeros_like(ref["rgb_raw"]) for o in obs]
            )
            rgb_manip = np.stack(
                [
                    o.get("manipulation_rgb_raw", o["rgb_raw"])
                    if o is not None
                    else np.zeros_like(ref["rgb_raw"])
                    for o in obs
                ]
            )
            new_episode = np.array(
                [bool(s.new_episode) if s is not None else False for s in steps]
            )
            oih = np.array(
                [
                    int(np.asarray(o.get("an_object_is_in_hand", 0)).reshape(-1)[0])
                    if o is not None
                    else 0
                    for o in obs
                ],
                np.int32,
            )
            agent.reset_streams(new_episode)
            actions = agent.act(rgb_nav, rgb_manip, (~new_episode).astype(np.int32), oih)

            if (
                recorder is not None
                and active[0]
                and episodes_on_stream0 % self.video_every == 0
                and obs[0] is not None
            ):
                probs = getattr(agent, "last_probs", None)
                recorder.add(
                    rgb_nav[0],
                    step=int(episode_steps[0]),
                    action_name=ALL_STRETCH_ACTIONS[int(actions[0])],
                    chosen=int(actions[0]),
                    probs=probs[0] if probs is not None else None,
                )

            next_steps = pool.step([int(a) for a in actions])
            episode_steps += 1
            for i, s in enumerate(next_steps):
                if not active[i]:
                    continue
                if s.metrics is not None:
                    m = dict(s.metrics)
                    m["ep_steps_measured"] = int(episode_steps[i])
                    top_down = m.pop("top_down_frame", None)
                    if top_down is not None and self.video_dir:
                        sid = m.get("task_info", {}).get("eval_info", {}).get(
                            "sample_id", m.get("task_info", {}).get("id", "ep")
                        )
                        safe = (
                            str(sid)
                            .replace("/", "_")
                            .replace("=", "-")
                            .replace(",", "_")
                        )
                        m["top_down_path"] = save_image(
                            top_down,
                            f"{self.video_dir}/{safe}_topdown.png",
                        )
                    all_metrics.append(m)
                    episode_steps[i] = 0
                    if i == 0 and recorder is not None:
                        if episodes_on_stream0 % self.video_every == 0:
                            sample_id = m.get("task_info", {}).get("eval_info", {}).get(
                                "sample_id", f"ep{episodes_on_stream0}"
                            )
                            path = recorder.save(sample_id)
                            if path:
                                m["video_path"] = path
                        episodes_on_stream0 += 1
                    if len(all_metrics) % progress_every == 0:
                        done_n = len(all_metrics)
                        rate = done_n / max(time.time() - t0, 1e-9)
                        eta = (total - done_n) / max(rate, 1e-9)
                        print(
                            f"eval progress {done_n}/{total} "
                            f"({rate:.2f} eps/s, ETA {eta:.0f}s)",
                            flush=True,
                        )
                if s.done and not s.new_episode:
                    active[i] = False
            # install fresh instructions
            agent.set_instructions(
                [
                    s.instruction if (s is not None and s.new_episode) else None
                    for s in next_steps
                ]
            )
            steps = next_steps

        pool.close()
        return self.aggregate_results(all_metrics, task_type)

    # ------------------------------------------------------------------
    @staticmethod
    def log_results(logger, results: Dict[str, Any], step: int = 0):
        """Push aggregate + per-episode safety + per-object tables to a
        WandbLogger (reference online_evaluator.py:701-795)."""
        logger.log(results["aggregate"], step, prefix=f"eval/{results['task_type']}")
        rows = [
            [r.get(c) for c in SAFETY_TABLE_COLUMNS] for r in results["safety_table"]
        ]
        logger.log_table(
            f"eval/{results['task_type']}/safety", SAFETY_TABLE_COLUMNS, rows, step
        )
        obj_rows = [
            [obj] + [d.get(k) for k in ("success", "cost", "sel", "spl")]
            for obj, d in results["per_object"].items()
        ]
        logger.log_table(
            f"eval/{results['task_type']}/per_object",
            ["object", "success", "cost", "sel", "spl"],
            obj_rows,
            step,
        )

    @staticmethod
    def aggregate_results(
        all_metrics: List[Dict[str, Any]], task_type: str
    ) -> Dict[str, Any]:
        agg: Dict[str, MetricAggregator] = defaultdict(MetricAggregator)
        per_object: Dict[str, Dict[str, MetricAggregator]] = defaultdict(
            lambda: defaultdict(MetricAggregator)
        )
        safety_table = []
        for m in all_metrics:
            for k, v in m.items():
                if isinstance(v, (bool, np.bool_)):
                    agg[k].update(float(v))
                elif isinstance(v, (int, float, np.integer, np.floating)):
                    agg[k].update(float(v))
            info = m.get("task_info", {})
            synsets = info.get("synsets", [])
            obj_key = synsets[0] if synsets else "unknown"
            for k in ("success", "cost", "sel", "spl"):
                if k in m and m[k] is not None:
                    per_object[obj_key][k].update(float(m[k]))
            safety_table.append(
                {
                    "sample_id": info.get("eval_info", {}).get("sample_id", info.get("id", "")),
                    **{
                        k: m.get(k)
                        for k in SAFETY_TABLE_COLUMNS[1:]
                    },
                }
            )
        return {
            "task_type": task_type,
            "num_episodes": len(all_metrics),
            "aggregate": {k: v.aggregate() for k, v in agg.items()},
            "per_object": {
                obj: {k: v.aggregate() for k, v in d.items()}
                for obj, d in per_object.items()
            },
            "safety_table": safety_table,
        }
