"""Benchmark evaluation CLI of the port (the JAX package's `cli/evaluate.py`):

    python -m safevla_tpu_torch.cli.evaluate --ckpt path/to/ckpt \
        --benchmark benchmark/objectnavtype_val.jsonl.gz \
        eval.num_workers=8 eval.seed=123 [--fake-env]

The agent runs on the card (`main(..., device="cpu")` runs it on the CPU,
as the tests do). `--ckpt` is a directory of the port's checkpoint format, a
reference torch file, or absent (random init); JAX Orbax checkpoints are
converted first with `tools/torch_from_orbax.py`. Every task type of
`tasks.REGISTERED_TASKS` evaluates. Without `--fake-env` the episodes run
in AI2-THOR (`StretchController`, which needs `ai2thor`) over the houses of
`--houses-dir` (or `objaverse_houses_dir`), read from its `val.jsonl.gz`.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import random
import sys

import numpy as np


def main(argv=None, device="cuda"):
    argv = argv if argv is not None else sys.argv[1:]
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--ckpt", default=None)
    parser.add_argument("--benchmark", required=True,
                        help="benchmark episodes .jsonl.gz (or .json list); "
                        "with --tasks, a DIRECTORY holding "
                        "<tasktype>_val.jsonl.gz files")
    parser.add_argument("--task-type", default="ObjectNavType")
    parser.add_argument("--tasks", default=None,
                        help="evaluate a task mixture: a named mixture "
                        "(data/mixtures.py) or comma-separated task types "
                        "(reference online_eval.py multi-task path)")
    parser.add_argument("--eval-set-size", type=int, default=None,
                        help="cap episodes per task type (reference "
                        "online_eval.py --eval_set_size)")
    parser.add_argument("--shuffle", action="store_true",
                        help="shuffle episode order with eval.seed")
    parser.add_argument("--houses-dir", default=None)
    parser.add_argument("--fake-env", action="store_true")
    parser.add_argument("--mode", default="greedy", choices=["greedy", "sample"])
    parser.add_argument("--output", default=None, help="write results json here")
    parser.add_argument("--video-dir", default=None,
                        help="record annotated episode videos + top-down maps here")
    parser.add_argument("--video-every", type=int, default=1,
                        help="record every Nth episode of stream 0")
    parser.add_argument("overrides", nargs="*")
    args = parser.parse_args(argv)

    from safevla_tpu_torch.config import Config, apply_overrides
    from safevla_tpu_torch.constants import ALL_STRETCH_ACTIONS
    from safevla_tpu_torch.data.mixtures import get_mixture_by_name
    from safevla_tpu_torch.envs.fake_controller import FakeController
    from safevla_tpu_torch.envs.sensors import default_train_sensors
    from safevla_tpu_torch.evaluation.agent import InferenceAgent
    from safevla_tpu_torch.evaluation.evaluator import BatchedEvaluator
    from safevla_tpu_torch.evaluation.types import (
        MAX_EPISODE_LEN_PER_TASK,
        load_benchmark_episodes,
        normalized_eval_sample_to_task_spec,
    )
    from safevla_tpu_torch.tasks import MultiTaskSampler, TaskSpecQueue
    from safevla_tpu_torch.utils.wandb_logging import WandbLogger

    cfg = apply_overrides(Config(), args.overrides)

    # single task, or a mixture (reference online_eval.py's multi-task path:
    # a named mixture or explicit list; --benchmark then points at the
    # directory of per-task <tasktype>_val.jsonl.gz files)
    if args.tasks:
        if "," in args.tasks:
            task_types = [t.strip() for t in args.tasks.split(",") if t.strip()]
        else:
            task_types = list(get_mixture_by_name(args.tasks))
        bench_paths = {
            t: os.path.join(args.benchmark, f"{t.lower()}_val.jsonl.gz")
            for t in task_types
        }
    else:
        task_types = [args.task_type]
        bench_paths = {args.task_type: args.benchmark}

    samples_by_task = {t: load_benchmark_episodes(p) for t, p in bench_paths.items()}
    if args.shuffle:
        rng = random.Random(cfg.eval.seed)
        for v in samples_by_task.values():
            rng.shuffle(v)
    if args.eval_set_size:
        samples_by_task = {
            t: v[: args.eval_set_size] for t, v in samples_by_task.items()
        }

    max_len = max(MAX_EPISODE_LEN_PER_TASK.get(t, 600) for t in task_types)
    if not any(o.startswith("model.max_steps=") for o in args.overrides):
        # the KV cache must cover the eval episode cap (train default is 500)
        cfg.model = dataclasses.replace(cfg.model, max_steps=max_len)
        cfg.train.max_steps = max_len
    h, w = cfg.model.image_size

    all_needed = sorted(
        {int(s["house_index"]) for v in samples_by_task.values() for s in v}
    )
    if args.fake_env:
        controller_type, controller_args = FakeController, {
            "seed": 0, "image_height": h, "image_width": w,
        }
        houses, house_inds = [{"rooms": [{}, {}]}], [0]
    else:
        from safevla_tpu_torch.data.stores import LazyJsonHouses
        from safevla_tpu_torch.envs.thor_controller import StretchController, default_thor_env_args

        assert args.houses_dir or cfg.objaverse_houses_dir
        houses_store = LazyJsonHouses.from_dir(
            args.houses_dir or cfg.objaverse_houses_dir, subset="val"
        )
        houses = [houses_store[i] for i in all_needed]
        house_inds = all_needed
        controller_type, controller_args = StretchController, default_thor_env_args()

    def factory_builder(tasks_queue):
        def factory(stream_id: int):
            return MultiTaskSampler(
                mode="val",
                task_args=dict(
                    sensors=default_train_sensors(rgb_height=h, rgb_width=w),
                    max_steps=max_len,
                    action_names=ALL_STRETCH_ACTIONS,
                    reward_config=None,
                ),
                # stream 0 renders top-down path maps when recording
                visualize=bool(args.video_dir) and stream_id == 0,
                houses=houses,
                house_inds=house_inds,
                controller_args=controller_args,
                controller_type=controller_type,
                task_spec_sampler=TaskSpecQueue(
                    tasks_queue, convert=normalized_eval_sample_to_task_spec, timeout=1.0
                ),
                seed=cfg.eval.seed,
            )

        return factory

    agent = InferenceAgent.build(
        cfg,
        args.ckpt,
        num_streams=cfg.eval.num_workers,
        mode=args.mode,
        seed=cfg.eval.seed,
        test_augmentation=cfg.eval.test_augmentation,
        max_episode_steps=max_len,
        # benchmark-protocol eval is a parity surface: refuse the hash
        # tokenizer unless explicitly running against fake environments
        require_exact_tokenizer=not args.fake_env,
        device=device,
    )
    evaluator = BatchedEvaluator(
        cfg,
        factory_builder,
        num_streams=cfg.eval.num_workers,
        # inline streams, in AI2-THOR too: they drain one in-process queue of
        # episodes (JAX asks for worker processes there, which each would
        # drain a copy of it)
        num_workers=0,
        video_dir=args.video_dir,
        video_every=args.video_every if args.video_dir else 0,
    )

    logger = WandbLogger(output_dir=os.path.join(cfg.train.output_dir, "eval"))
    per_task = {}
    for t in task_types:
        # fresh episodes handle cache/position reset via the episode-window
        # attention mask (as in training); only prev-action needs zeroing
        agent.reset_streams(np.ones(cfg.eval.num_workers, bool))
        per_task[t] = evaluator.evaluate(agent, samples_by_task[t], t)
        BatchedEvaluator.log_results(logger, per_task[t])
    logger.finish()

    if len(task_types) == 1:
        results = per_task[task_types[0]]
        print(json.dumps(results["aggregate"], indent=2, default=float))
    else:
        results = {"per_task": per_task}
        print(json.dumps({t: r["aggregate"] for t, r in per_task.items()}, indent=2, default=float))
    if args.output:
        with open(args.output, "w") as f:
            json.dump(results, f, default=float)
        print(f"full results -> {args.output}")
    return results


if __name__ == "__main__":
    main()
