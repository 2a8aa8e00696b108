#!/usr/bin/env python3
"""The ConstrainedBandit probe of `tests/test_learning.py` (130 updates of 4
streams x 8 steps, cost limit 2, 10 warm-up updates, per-window episode
means) through the JAX package's trainer and the port's, over several
`train.seed` values, on the CPU:

    python3 tools/torch_probe_seeds.py --seeds 123,1,2,3 --modes sync,async --workers 6

Each run (one package, one pipeline, one seed) is a process of its own,
`--workers` at a time, each on one CPU thread. One JSON line a run on
stdout: the initial, peak (best moving mean over the last eighth's length)
and last-eighth windowed return, the peak and last-eighth episode cost, the
peak lambda, the entropy at the start and over the last eighth, and the
verdicts of `_check_dynamics`'s two last-eighth reward criteria. It imports
both packages (the port itself never imports JAX).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

UPDATES, WARMUP, STREAMS, EP_STEPS, COST_LIMIT = 130, 10, 4, 8, 2.0


def run_one(pkg: str, mode: str, seed: int) -> dict:
    """One probe run in this process -> its summary."""
    import numpy as np

    if pkg == "jax":
        import jax

        jax.config.update("jax_platforms", "cpu")
        from safevla_tpu.tasks.probe import make_probe_sampler_factory, probe_train_config
        from safevla_tpu.training.online import OnlineTrainer

        extra = {"mesh": None}
    else:
        import torch

        torch.set_num_threads(1)
        from safevla_tpu_torch.tasks.probe import make_probe_sampler_factory, probe_train_config
        from safevla_tpu_torch.training.online import OnlineTrainer

        extra = {"device": "cpu"}
    cfg = probe_train_config(UPDATES, "ConstrainedBandit", streams=STREAMS, rollout_steps=EP_STEPS,
                             episode_steps=EP_STEPS, cost_limit=COST_LIMIT, warmup_updates=WARMUP)
    cfg.train.seed = seed
    series = []
    trainer = OnlineTrainer(cfg, make_probe_sampler_factory(cfg, episode_max_steps=EP_STEPS), num_workers=0,
                            log_fn=lambda metrics, step: series.append(metrics),
                            async_pipeline=mode == "async", **extra)
    inner = trainer.log_fn

    def windowed(metrics, step):
        inner(metrics, step)
        trainer.episode_accum.reset()

    trainer.log_fn = windowed
    try:
        trainer.train()
    finally:
        trainer.close()
    rl = [r for r in series if r.get("stage", 1) >= 1]
    reward = [r["ep/total_reward"] for r in rl if "ep/total_reward" in r]
    cost = [r["mean_episode_cost"] for r in rl]
    ent = [r["entropy"] for r in rl]
    tail = max(1, len(reward) // 8)
    initial, final = float(np.mean(reward[:10])), float(np.mean(reward[-tail:]))
    safe_only = EP_STEPS * 0.4  # ConstrainedBanditTask.optima's safe-only return
    return {
        "pkg": pkg, "mode": mode, "seed": seed, "initial_reward": initial, "final_reward": final,
        "peak_reward": max(float(np.mean(reward[i : i + tail])) for i in range(len(reward) - tail + 1)),
        "peak_cost": max(cost), "final_cost": float(np.mean(cost[-tail:])),
        "peak_lambda": max(r["lagrange_multiplier"] for r in rl),
        "initial_entropy": float(np.mean(ent[:10])), "final_entropy": float(np.mean(ent[-tail:])),
        "reward_rose": final > 2.0 * max(initial, 0.25), "beats_safe_only": final > 0.9 * safe_only,
    }


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--seeds", default="123,1,2,3")
    parser.add_argument("--modes", default="sync,async")
    parser.add_argument("--pkgs", default="jax,port")
    parser.add_argument("--workers", type=int, default=4)
    parser.add_argument("--run", nargs=3, metavar=("PKG", "MODE", "SEED"), help=argparse.SUPPRESS)
    args = parser.parse_args()
    if args.run:
        pkg, mode, seed = args.run
        print("RESULT " + json.dumps(run_one(pkg, mode, int(seed))), flush=True)
        return 0
    env = dict(os.environ, XLA_FLAGS="--xla_cpu_multi_thread_eigen=false intra_op_parallelism_threads=1")
    jobs = [(p, m, s) for p in args.pkgs.split(",") for m in args.modes.split(",") for s in args.seeds.split(",")]

    def child(job):
        out = subprocess.run([sys.executable, __file__, "--run", *job], capture_output=True, text=True, env=env)
        lines = [line[len("RESULT ") :] for line in out.stdout.splitlines() if line.startswith("RESULT ")]
        if out.returncode or not lines:
            raise RuntimeError(f"{job} failed ({out.returncode}):\n{out.stderr[-2000:]}")
        return lines[0]

    with ThreadPoolExecutor(args.workers) as pool:
        for line in pool.map(child, jobs):
            print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
