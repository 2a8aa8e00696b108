"""Rank functions of the port's data-parallel tests, and the spawner that
runs them.

`run_ranks(name, world, payload, tmp_path)` starts `world` Python processes
on this host, each one rank of a gloo group on the CPU (the SAFEVLA_* env
vars, or torchrun's, with a coordinator on a free port), runs
`RANK_FNS[name](payload)` in each and returns their results in rank order.
A rank that fails or outlives the timeout fails the call (every process is
killed first). The ranks import torch, numpy and the port only: this module
imports nothing of JAX, and the payload holds plain dicts and numpy arrays.
"""

from __future__ import annotations

import dataclasses
import functools
import os
import pathlib
import pickle
import random
import socket
import subprocess
import sys
import time
from collections import deque

import numpy as np
import torch

TESTS = pathlib.Path(__file__).resolve().parent
REPO = TESTS.parent
_CHILD = f"import sys; sys.path.insert(0, {str(TESTS)!r}); import torch_parallel_ranks as r; r.child_main()"
_DIST_ENV = ("SAFEVLA_", "XLA_", "MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE", "LOCAL_RANK")


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_ranks(name, world, payload, tmp_path, timeout=150, torchrun_env=False):
    return start_ranks(name, world, payload, tmp_path, timeout, torchrun_env).wait()


class start_ranks:
    """The ranks started; `wait()` returns their results (a test overlaps
    its own work with theirs in between)."""

    def __init__(self, name, world, payload, tmp_path, timeout=150, torchrun_env=False):
        tmp_path = pathlib.Path(tmp_path)
        payload_path = tmp_path / f"{name}_payload.pkl"
        with open(payload_path, "wb") as f:
            pickle.dump(payload, f)
        port = free_port()
        base = {k: v for k, v in os.environ.items() if not k.startswith(_DIST_ENV)}
        base["OMP_NUM_THREADS"] = "1"
        if torchrun_env:
            base.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), WORLD_SIZE=str(world))
        else:
            base.update(SAFEVLA_COORDINATOR=f"127.0.0.1:{port}", SAFEVLA_NUM_PROCESSES=str(world))
        self.name, self.procs, self.outs = name, [], []
        for rank in range(world):
            env = dict(base, RANK=str(rank), LOCAL_RANK=str(rank)) if torchrun_env else dict(
                base, SAFEVLA_PROCESS_ID=str(rank))
            out = tmp_path / f"{name}_rank{rank}.pkl"
            self.outs.append(out)
            self.procs.append(subprocess.Popen(
                [sys.executable, "-c", _CHILD, name, str(payload_path), str(out)],
                cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            ))
        self.deadline = time.time() + timeout

    def wait(self):
        logs = []
        try:
            for p in self.procs:
                logs.append(p.communicate(timeout=max(self.deadline - time.time(), 1))[0])
        except subprocess.TimeoutExpired:
            for p in self.procs:
                p.kill()
                p.wait()
            raise
        for rank, (p, log) in enumerate(zip(self.procs, logs)):
            assert p.returncode == 0, f"rank {rank} of {self.name} failed:\n{log}"
        results = []
        for out in self.outs:
            with open(out, "rb") as f:
                results.append(pickle.load(f))
        return results


def child_main():
    name, payload_path, out_path = sys.argv[1:4]
    torch.set_num_threads(1)
    with open(payload_path, "rb") as f:
        payload = pickle.load(f)
    result = RANK_FNS[name](payload)
    with open(out_path, "wb") as f:
        pickle.dump(result, f)


def _join(payload=None):
    """This rank into the group, on the payload's device and backend (the
    CPU and gloo by default)."""
    from safevla_tpu_torch.parallel.distributed import initialize_multihost

    payload = payload or {}
    return initialize_multihost(device=payload.get("device", "cpu"), backend=payload.get("backend"), timeout_s=120)


# ---------------------------------------------------------------------------
# shared set-up: the tiny config of tests/torch_port_tiny.py, on the port's side
# ---------------------------------------------------------------------------
def _register_vit(payload):
    from safevla_tpu_torch.models import vit as pvit

    pvit.VIT_CONFIGS[payload["vit"]] = pvit.DinoViTConfig(dtype=torch.float32, **payload["vit_kw"])


def _f32_t5():
    from safevla_tpu_torch.models import actor_critic as pac
    from safevla_tpu_torch.models import t5 as pt5

    pac.T5Config = functools.partial(pt5.T5Config, dtype=torch.float32)


def _config(payload):
    from safevla_tpu_torch.config import Config, ModelConfig

    cfg = Config(ModelConfig(**payload["model"]))
    for section, values in payload.get("overrides", {}).items():
        for k, v in values.items():
            setattr(getattr(cfg, section), k, v)
    if "stage0_steps" in payload:
        cfg.train.stages[0].max_stage_steps = payload["stage0_steps"]
    return cfg


def towers_np(policy):
    return [{k: v.detach().float().cpu().numpy() for k, v in t.state_dict().items()} for t in policy.towers]


def _update_result(learner, ts, metrics):
    lag = ts.lagrange
    return {
        "metrics": {k: float(v) for k, v in metrics.items()},
        "towers": towers_np(learner.policy),
        "multiplier": float(lag.multiplier),
        "lagrange_count": lag.opt_state.count,
        "count": ts.opt_state.count,
        "step": ts.step,
    }


def window(model, b, t, seed):
    """A (b, t) rollout window of numpy arrays from a seed, for a model
    config dict: two episodes per stream (a boundary at a random step, the
    instruction table indexed by episode), integer costs 0-2."""
    rng = np.random.default_rng(seed)
    f = lambda *shape: rng.standard_normal(shape).astype(np.float32)
    (gh, gw), dv, n_act = model["vision_grid"], model["vision_feature_dim"], model["num_actions"]
    boundary = rng.integers(1, t, b)
    steps = np.arange(t)[None, :]
    traj = (steps >= boundary[:, None]).astype(np.int32)
    not_reset = (steps != boundary[:, None]).astype(np.int32)
    masks = np.ones((b, t + 1), np.float32)
    masks[:, :t] = not_reset
    L = model["text_max_tokens"]
    return {
        "dino_nav": f(b, t, gh, gw, dv), "dino_manip": f(b, t, gh, gw, dv),
        "text_hidden": f(b, 2, L, model["text_embed_size"]),
        "text_mask": np.arange(L) < rng.integers(1, L + 1, (b, 2))[..., None],
        "text_idx": traj, "prev_actions": rng.integers(0, n_act, (b, t)).astype(np.int32),
        "not_reset": not_reset, "object_in_hand": rng.integers(0, 3, (b, t)).astype(np.int32),
        "time_step": np.where(traj == 0, steps, steps - boundary[:, None]).astype(np.int32),
        "traj_idx": traj, "actions": rng.integers(0, n_act, (b, t)).astype(np.int32),
        "old_log_probs": (-3.0 + 0.1 * f(b, t)).astype(np.float32), "rewards": f(b, t),
        "costs": rng.integers(0, 3, (b, t)).astype(np.float32), "values": f(b, t + 1),
        "c_values": f(b, t + 1), "masks": masks,
    }


def seeded_policy(cfg, payload, device):
    """The payload's weights: JAX's tree (`params`) or a generator's (`seed`)."""
    from safevla_tpu_torch.models.actor_critic import SafeVLAPolicy
    from safevla_tpu_torch.models.from_jax import load_jax_params

    if "params" in payload:
        return load_jax_params(SafeVLAPolicy(cfg.model, device=device), payload["params"])
    return SafeVLAPolicy(cfg.model, device=device, generator=torch.Generator().manual_seed(payload["seed"]))


def learner_update(payload):
    """Learner.update and Learner.chunked_update, each from the payload's
    weights, on this rank's rows of the payload's window."""
    from safevla_tpu_torch.algo.learner import Learner
    from safevla_tpu_torch.parallel import make_mesh, shard_batch

    _join(payload)
    _register_vit(payload)
    cfg = _config(payload)
    mesh = make_mesh(dp=payload["dp"], mdl=payload["mdl"])
    out = {"dp_index": mesh.dp_index, "shape": mesh.shape}
    for kind in payload["kinds"]:
        policy = seeded_policy(cfg, payload, mesh.device)
        learner = Learner(policy, cfg, mesh)
        run = learner.update if kind == "update" else learner.chunked_update
        ts, metrics = run(learner.init(), shard_batch(mesh, payload["batch"]), payload["cost"], payload["stage"])
        out[kind] = _update_result(learner, ts, metrics)
    return out


def bc_step(payload):
    """One OfflineTrainer._bc_step on this rank's rows of the payload's host
    batch (the payload's AugmentParams), the global gradient at the old
    weights, and `_eval_step` on this rank's rows of the eval batch."""
    from safevla_tpu_torch.models.from_jax import load_jax_params
    from safevla_tpu_torch.parallel import make_mesh
    from safevla_tpu_torch.preprocessing.augment import AugmentParams
    from safevla_tpu_torch.training.offline import OfflineTrainer

    _join()
    _register_vit(payload)
    _f32_t5()
    cfg = _config(payload)
    mesh = make_mesh(dp=payload["dp"], mdl=payload["mdl"]) if payload["dp"] else None
    trainer = OfflineTrainer(cfg, mesh=mesh, device="cpu")
    load_jax_params(trainer.policy, payload["params"])
    state = trainer.init_state()
    aug = AugmentParams(*payload["aug"])
    batch = trainer.prepare_batch(trainer._rank_rows(payload["host_batch"]))
    loss, _ = trainer._bc_loss(batch, aug)
    named = list(trainer.policy.towers[0].named_parameters())
    grads = [torch.zeros_like(p) if g is None else g
             for (_, p), g in zip(named, torch.autograd.grad(loss, [p for _, p in named], allow_unused=True))]
    if mesh is not None:
        mesh.all_reduce_mean_(grads)
    state, metrics = trainer._bc_step(state, batch, aug)
    ev = trainer._eval_step(state, trainer.prepare_batch(trainer._rank_rows(payload["eval_batch"])))
    return {
        "metrics": {k: float(v) for k, v in metrics.items()},
        "step": state.step, "count": state.opt_state.count,
        "towers": towers_np(trainer.policy),
        "grads": {n: g.numpy().copy() for (n, _), g in zip(named, grads)},
        "eval": {"val_loss": float(ev["val_loss"]), "val_accuracy": float(ev["val_accuracy"]),
                 "preds": ev["preds"].numpy(), "valid": ev["valid"].numpy()},
    }


def reseed_hosts(seed: int) -> None:
    """The task samplers draw from the global `random` and `np.random`."""
    random.seed(seed)
    np.random.seed(seed)


def costly(factory):
    """Stream i's tasks add a cost of (i + steps taken) % 3 to each step
    (FakeController ObjectNav episodes this short cost nothing): episode
    costs that differ by stream, so the order they are recorded in shows."""

    def make(stream_id):
        sampler = factory(stream_id)
        next_task = sampler.next_task

        def with_costs(*a, **kw):
            task = next_task(*a, **kw)
            if task is not None:
                step = task.step

                def costly_step(action):
                    res = step(action)
                    return dataclasses.replace(res, cost=res.cost + (stream_id + task.num_steps_taken()) % 3)

                task.step = costly_step
            return task

        sampler.next_task = with_costs
        return sampler

    return make


def trainer_windows(payload):
    """OnlineTrainer.train over the payload's windows (sync), with each
    collect's actions and stats recorded, the episode-cost window cut to
    the payload's length; on a mesh when the payload's dp is set (this rank
    of a group, mdl from the payload), else alone."""
    from safevla_tpu_torch.envs.fake_tasks import make_sampler_factory
    from safevla_tpu_torch.parallel import make_mesh
    from safevla_tpu_torch.training.online import OnlineTrainer

    mesh = None
    if payload["dp"]:
        _join()
        mesh = make_mesh(dp=payload["dp"], mdl=payload.get("mdl", 1))
    _register_vit(payload)
    cfg = _config(payload)
    reseed_hosts(5)
    logs, windows = [], []
    trainer = OnlineTrainer(cfg, costly(make_sampler_factory(max_steps=payload["episode_steps"])), num_workers=0,
                            log_fn=lambda m, s: logs.append((s, m)), device="cpu", mesh=mesh)
    trainer.runner.episode_costs = deque(maxlen=payload["episode_cost_window"])
    collect = trainer.runner.collect

    def recorded(*a, **kw):
        batch, stats = collect(*a, **kw)
        windows.append({"actions": batch["actions"].numpy().copy(), "stats": dict(stats)})
        return batch, stats

    trainer.runner.collect = recorded
    ts = trainer.train(payload["total_steps"])
    trainer.close()
    return {"stream_ids": trainer.pool.stream_ids, "windows": windows, "logs": logs, "step": ts.step,
            "towers": towers_np(trainer.policy), "episode_costs": list(trainer.runner.episode_costs),
            "n_groups": trainer.runner.n_groups}


def train_online_cli(payload):
    """`cli.train_online.main(argv, device="cpu")` with the SAFEVLA_* env
    of a group: the CLI joins the group itself. Returns the TrainState's
    step, the towers, and the checkpoint files this rank wrote."""
    import torch.distributed as dist

    from safevla_tpu_torch.cli import train_online

    written = []
    save = torch.save

    def counted(obj, f, *a, **kw):
        written.append(str(f))
        return save(obj, f, *a, **kw)

    torch.save = counted
    reseed_hosts(5)
    ts = train_online.main(payload["argv"], device="cpu")
    assert not dist.is_initialized()  # the CLI left the group it joined
    return {"step": ts.step, "towers": {k: v.detach().numpy().copy() for k, v in ts.tower_params.items()},
            "written": written}


def group_basics(payload):
    """initialize_multihost's dict, is_primary_host, an all-reduce over the
    device group (JAX's psum test: (1 + 2) * 4), the host group's gather, and
    the mesh helpers."""
    import torch.distributed as dist

    from safevla_tpu_torch.parallel import batch_sharding, make_mesh, replicated_sharding, shard_batch
    from safevla_tpu_torch.parallel.distributed import is_primary_host, shutdown_multihost

    info = _join()
    rank = info["process_index"]
    mesh = make_mesh()
    x = torch.full((4,), float(rank + 1))
    mesh.all_reduce_sum(x)
    tree = {"a": np.arange(12).reshape(6, 2), "b": [torch.arange(6)], "n": 3}
    local = shard_batch(mesh, tree)
    try:
        make_mesh(dp=mesh.world_size + 1)
        bad_mesh = None
    except AssertionError as e:
        bad_mesh = str(e)
    out = {
        "info": info, "primary": is_primary_host(), "sum": x.tolist(), "shape": mesh.shape,
        "gathered": mesh.gather_objects({"rank": rank}), "any": mesh.any(rank == 1),
        "local_a": local["a"].numpy(), "local_b": local["b"][0].numpy(), "n": local["n"],
        "batch_local": batch_sharding(mesh).local(np.arange(6)).numpy(),
        "replicated_local": replicated_sharding(mesh).local(np.arange(6)).numpy(),
        "bad_mesh": bad_mesh, "backend": dist.get_backend(),
    }
    shutdown_multihost()
    out["after_shutdown"] = dist.is_initialized()
    return out


def refusals(payload):
    """initialize_multihost on a backend or a device this host lacks: it
    raises, and swaps in nothing (the group stays uninitialised)."""
    import torch.distributed as dist

    from safevla_tpu_torch.parallel.distributed import initialize_multihost

    out = {}
    for name, kw in (("nccl", {"backend": "nccl", "device": "cpu"}), ("cuda", {"device": "cuda"})):
        try:
            initialize_multihost(timeout_s=30, **kw)
            out[name] = None
        except Exception as e:  # what it raised, for the test to read
            out[name] = f"{type(e).__name__}: {e}"
        out[name + "_initialized"] = dist.is_initialized()
    return out


RANK_FNS = {
    "learner_update": learner_update,
    "bc_step": bc_step,
    "trainer_windows": trainer_windows,
    "train_online_cli": train_online_cli,
    "group_basics": group_basics,
    "refusals": refusals,
}


def model_payload(mcfg, vit, vit_kw):
    """The payload's model keys: a JAX ModelConfig as a dict, the tiny ViT."""
    return {"model": dataclasses.asdict(mcfg), "vit": vit, "vit_kw": dict(vit_kw)}
