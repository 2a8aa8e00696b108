"""The port's evaluation slice on the CPU: `BatchedEvaluator` against the JAX
package's, the evaluation CLI, and `InferenceAgent.build` from every
checkpoint layout it reads.

* Both evaluators run the same tiny f32 weights (`load_jax_params`) over the
  same FakeController episodes, greedy and without test-time augmentation
  (the two packages draw augmentations differently by design): the
  per-episode safety table must be identical and every aggregate within
  1e-6.
* `cli.evaluate.main([... "--fake-env"], device="cpu")` on a tiny
  `.jsonl.gz`.
* An agent built from a port trainer checkpoint (a run directory), from a
  bare params export, and from each reference container acts bit-equal to
  an agent over the in-memory policy; a foreign tree raises; a checkpoint
  saved from a policy of one seed restores that policy's ViT and T5 into an
  agent built with another seed; a trainer checkpoint without the frozen
  encoders (the format before they were saved) still restores its towers.
"""

import copy
import dataclasses
import functools
import gzip
import json
import random
import sys
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_tiny as tiny
from safevla_tpu.config import Config as JaxConfig
from safevla_tpu.envs.fake_controller import FakeController as JaxFakeController
from safevla_tpu.envs.sensors import default_train_sensors as jax_sensors
from safevla_tpu.evaluation.agent import InferenceAgent as JaxAgent
from safevla_tpu.evaluation.evaluator import BatchedEvaluator as JaxEvaluator
from safevla_tpu.evaluation.types import normalized_eval_sample_to_task_spec as jax_to_spec
from safevla_tpu.models import actor_critic as jac
from safevla_tpu.models import t5 as jt5
from safevla_tpu.tasks import MultiTaskSampler as JaxSampler
from safevla_tpu.tasks import TaskSpecQueue as JaxQueue
from safevla_tpu_torch import config as pconfig
from safevla_tpu_torch.algo.learner import Learner
from safevla_tpu_torch.cli import evaluate as eval_cli
from safevla_tpu_torch.config import Config, ModelConfig, TrainConfig
from safevla_tpu_torch.constants import ALL_STRETCH_ACTIONS
from safevla_tpu_torch.envs.fake_controller import FakeController
from safevla_tpu_torch.envs.sensors import default_train_sensors
from safevla_tpu_torch.evaluation import types as ptypes
from safevla_tpu_torch.evaluation.agent import InferenceAgent
from safevla_tpu_torch.evaluation.evaluator import BatchedEvaluator
from safevla_tpu_torch.evaluation.types import normalized_eval_sample_to_task_spec
from safevla_tpu_torch.models import actor_critic as pac
from safevla_tpu_torch.models import convert
from safevla_tpu_torch.models import t5 as pt5
from safevla_tpu_torch.models.actor_critic import SafeVLAPolicy
from safevla_tpu_torch.tasks import MultiTaskSampler, TaskSpecQueue
from safevla_tpu_torch.utils import checkpoint as ckpt

STREAMS, EPISODES, EPISODE_LEN = 2, 4, 10


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    yield from tiny.one_torch_thread()


@pytest.fixture
def mcfg(tiny_model_cfg, monkeypatch):
    """The tiny f32 policy (f32 ViT and T5 on both sides, so that the two
    packages' greedy actions agree)."""
    tiny.register_tiny_vit(monkeypatch)
    monkeypatch.setattr(jac, "T5Config", functools.partial(jt5.T5Config, dtype=jnp.float32))
    monkeypatch.setattr(pac, "T5Config", functools.partial(pt5.T5Config, dtype=torch.float32))
    return tiny.model_cfg(tiny_model_cfg)


def _port_cfg(mcfg):
    return Config(ModelConfig(**dataclasses.asdict(mcfg)), TrainConfig(max_steps=mcfg.max_steps))


def _eval_samples(n):
    """ObjectNavType benchmark rows over FakeController(seed=0)'s objects."""
    objs = FakeController(seed=0).get_objects()
    samples = []
    for i in range(n):
        target = objs[i % len(objs)]
        synset = target["objectType"].lower() + ".n.01"
        ids = [o["objectId"] for o in objs if o["objectType"] == target["objectType"]]
        samples.append({
            "task_type": "ObjectNavType", "house_index": 0,
            "natural_language_spec": f"find a {target['objectType'].lower()}",
            "agent_starting_position": [1.5, 0.9, 3.0], "agent_y_rotation": float(i * 30),
            "expert_length": 10, "synsets": [synset],
            "synset_to_object_ids": {synset: ids}, "broad_synset_to_object_ids": {synset: ids},
        })
    return samples


def _factory_builder(hw, controller, sensors, sampler, queue, to_spec):
    def builder(tasks_queue):
        def factory(stream_id):
            return sampler(
                mode="val",
                task_args=dict(sensors=sensors(rgb_height=hw[0], rgb_width=hw[1]), max_steps=EPISODE_LEN,
                               action_names=ALL_STRETCH_ACTIONS, reward_config=None),
                houses=[{"rooms": [{}, {}]}], house_inds=[0],
                controller_args={"seed": 0, "image_height": hw[0], "image_width": hw[1]},
                controller_type=controller,
                task_spec_sampler=queue(tasks_queue, convert=to_spec, timeout=0.2),
                controller=controller(seed=0, image_height=hw[0], image_width=hw[1]),
            )

        return factory

    return builder


def test_batched_evaluator_matches_jax(mcfg):
    params = tiny.random_params(jac.SafeVLAPolicy(mcfg), seed=3)
    hw = mcfg.image_size
    samples = _eval_samples(EPISODES)
    results = {}

    jcfg = JaxConfig()
    jcfg.model = mcfg
    jcfg.train.max_steps = mcfg.max_steps
    random.seed(0), np.random.seed(0)
    jagent = JaxAgent(jcfg, jax.tree.map(jnp.asarray, params), STREAMS, mode="greedy", test_augmentation=False)
    builder = _factory_builder(hw, JaxFakeController, jax_sensors, JaxSampler, JaxQueue, jax_to_spec)
    evaluator = JaxEvaluator(jcfg, builder, num_streams=STREAMS, num_workers=0, max_episode_len=EPISODE_LEN)
    results["jax"] = evaluator.evaluate(jagent, samples, "ObjectNavType")

    pcfg = _port_cfg(mcfg)
    random.seed(0), np.random.seed(0)
    agent = InferenceAgent(pcfg, tiny.port_policy(mcfg, params), STREAMS, mode="greedy", test_augmentation=False)
    builder = _factory_builder(hw, FakeController, default_train_sensors, MultiTaskSampler, TaskSpecQueue,
                               normalized_eval_sample_to_task_spec)
    evaluator = BatchedEvaluator(pcfg, builder, num_streams=STREAMS, num_workers=0, max_episode_len=EPISODE_LEN)
    results["port"] = evaluator.evaluate(agent, samples, "ObjectNavType")

    got, want = results["port"], results["jax"]
    assert got["num_episodes"] == want["num_episodes"] == EPISODES
    assert got["safety_table"] == want["safety_table"]
    assert got["per_object"].keys() == want["per_object"].keys()
    assert got["aggregate"].keys() == want["aggregate"].keys()
    for k, v in want["aggregate"].items():
        assert abs(got["aggregate"][k] - v) <= 1e-6, k


def test_evaluate_cli_on_fake_env(mcfg, tmp_path, monkeypatch):
    benches = {}
    for task_type in ("ObjectNavType", "FetchType"):
        benches[task_type] = tmp_path / f"{task_type.lower()}_val.jsonl.gz"
        with gzip.open(benches[task_type], "wt") as f:
            for row in _eval_samples(3):
                f.write(json.dumps({**row, "task_type": task_type}) + "\n")
        # episodes of 12 steps at most, not the benchmark's: the size of the test
        monkeypatch.setitem(ptypes.MAX_EPISODE_LEN_PER_TASK, task_type, 12)
    tiny_cfg = _port_cfg(mcfg)
    monkeypatch.setattr(pconfig, "Config", lambda: dataclasses.replace(tiny_cfg, train=TrainConfig()))
    out = tmp_path / "results.json"
    args = ["--fake-env", "--eval-set-size", "2", "eval.num_workers=2", "eval.test_augmentation=false",
            f"train.output_dir={tmp_path}"]
    results = eval_cli.main(["--benchmark", str(benches["ObjectNavType"]), "--output", str(out), *args],
                            device="cpu")
    assert results["num_episodes"] == 2 and len(results["safety_table"]) == 2
    assert json.loads(out.read_text())["task_type"] == "ObjectNavType"
    # every registered task type evaluates (the fetch family here)
    results = eval_cli.main(["--benchmark", str(benches["FetchType"]), "--task-type", "FetchType", *args],
                            device="cpu")
    assert results["task_type"] == "FetchType" and results["num_episodes"] == 2


def test_evaluate_cli_in_thor_houses_matches_jax(mcfg, tmp_path, monkeypatch):
    """`cli.evaluate --houses-dir` (no `--fake-env`): StretchController on the
    mock AI2-THOR backend over the houses' `val.jsonl.gz`, in both packages,
    with the same tiny weights (each package's `InferenceAgent.build` patched
    to return an agent over them) and the T5 tokenizer's stand-in that the
    benchmark protocol requires. The per-episode safety table must be
    identical and every aggregate within 1e-6.

    The JAX CLI steps AI2-THOR streams in worker processes, which cannot
    work there: its task queue is an in-process `queue.Queue` and its
    sampler factory a closure that forkserver cannot pickle. Its evaluator is
    held to inline streams here, as the port's always runs them."""
    import safevla_tpu.cli.evaluate as jax_cli
    import safevla_tpu.config as jconfig
    import safevla_tpu.evaluation.evaluator as jevaluator
    import safevla_tpu.evaluation.types as jtypes
    import safevla_tpu.tasks.base as jax_task_base
    import safevla_tpu.utils.jax_cache as jax_cache
    import safevla_tpu_torch.tasks.base as task_base
    import torch_thor_mock as mock

    mock.install(mock.ModuleSetter(monkeypatch))
    from safevla_tpu.envs import thor_controller as jthor
    from safevla_tpu_torch.envs import thor_controller as pthor

    for thor in (jthor, pthor):  # render at 28 x 44, cropped to the tiny policy's 28 x 42
        monkeypatch.setattr(thor, "default_thor_env_args",
                            functools.partial(thor.default_thor_env_args, height=28, width=44))
    monkeypatch.setitem(sys.modules, "transformers", mock.text_tokenizer())
    monkeypatch.setattr(jax_cache, "enable_persistent_cache", lambda *a, **k: "")
    clock = SimpleNamespace(time=lambda: 1.7e9)
    monkeypatch.setattr(jax_task_base, "time", clock)
    monkeypatch.setattr(task_base, "time", clock)
    for types_mod in (ptypes, jtypes):  # episodes of EPISODE_LEN steps, not the benchmark's 500
        monkeypatch.setitem(types_mod.MAX_EPISODE_LEN_PER_TASK, "ObjectNavType", EPISODE_LEN)

    houses = [mock.make_house(seed) for seed in (5, 6)]
    houses_dir = tmp_path / "houses"
    houses_dir.mkdir()
    with gzip.open(houses_dir / "val.jsonl.gz", "wt") as f:
        f.writelines(json.dumps(h) + "\n" for h in houses)
    bench = tmp_path / "objectnavtype_val.jsonl.gz"
    with gzip.open(bench, "wt") as f:
        rows = mock.objectnav_rows(houses[1], 1, 2) + mock.objectnav_rows(houses[0], 0, 2)[1:]
        f.writelines(json.dumps(r) + "\n" for r in rows)

    params = tiny.random_params(jac.SafeVLAPolicy(mcfg), seed=3)
    jax_tiny = JaxConfig()
    jax_tiny.model = mcfg
    monkeypatch.setattr(jconfig, "Config", lambda: copy.deepcopy(jax_tiny))
    monkeypatch.setattr(pconfig, "Config", lambda: dataclasses.replace(_port_cfg(mcfg), train=TrainConfig()))

    def jax_build(cls, cfg, ckpt, num_streams, mode, seed, test_augmentation, **kw):
        return cls(cfg, jax.tree.map(jnp.asarray, params), num_streams, mode, seed, test_augmentation, **kw)

    def port_build(cls, cfg, ckpt, num_streams, mode, seed, test_augmentation, device, **kw):
        return cls(cfg, tiny.port_policy(mcfg, params), num_streams, mode, seed, test_augmentation, **kw)

    monkeypatch.setattr(JaxAgent, "build", classmethod(jax_build))
    monkeypatch.setattr(InferenceAgent, "build", classmethod(port_build))
    monkeypatch.setattr(jevaluator, "BatchedEvaluator", _inline(JaxEvaluator))
    args = ["--benchmark", str(bench), "--houses-dir", str(houses_dir), "eval.num_workers=2",
            "eval.test_augmentation=false", f"model.max_steps={mcfg.max_steps}", f"train.output_dir={tmp_path}"]
    results = {}
    random.seed(0), np.random.seed(0)
    results["jax"] = jax_cli.main(args)
    random.seed(0), np.random.seed(0)
    results["port"] = eval_cli.main(args, device="cpu")

    got, want = results["port"], results["jax"]
    assert got["num_episodes"] == want["num_episodes"] == len(rows)
    assert got["safety_table"] == want["safety_table"]
    assert {r["sample_id"] for r in got["safety_table"]} == {
        f"task=ObjectNavType,house={r['house_index']},sub_house_id={i}" for i, r in enumerate(rows)}
    assert got["aggregate"].keys() == want["aggregate"].keys()
    for k, v in want["aggregate"].items():
        assert abs(got["aggregate"][k] - v) <= 1e-6, k
    # without the T5 tokenizer's files the benchmark protocol refuses to run
    monkeypatch.delitem(sys.modules, "transformers")
    monkeypatch.setitem(sys.modules, "transformers", None)
    with pytest.raises(RuntimeError, match="requires exact"):
        eval_cli.main(args, device="cpu")


def _inline(evaluator_cls):
    """`evaluator_cls` with its streams stepped inline (num_workers=0)."""

    class Inline(evaluator_cls):
        def __init__(self, *a, **k):
            super().__init__(*a, **{**k, "num_workers": 0})

    return Inline


def _acts(agent, steps=3):
    """Greedy actions and action distributions of a few acts on fixed frames."""
    agent.set_instructions(["find a mug", "go to the bed"])
    h, w = agent.cfg.model.image_size
    rng = np.random.default_rng(11)
    out = []
    for t in range(steps):
        frames = rng.integers(0, 256, (2, 2, h, w, 3), dtype=np.uint8)
        out.append((agent.act(frames[0], frames[1], np.full(2, int(t > 0)), np.zeros(2, np.int32)),
                    agent.last_probs))
    return out


def _same_acts(a, b):
    return all(np.array_equal(x[0], y[0]) and np.array_equal(x[1], y[1]) for x, y in zip(a, b))


def _agent(cfg, policy):
    """An agent over the in-memory policy, frozen as `build` freezes its own
    (CPU kernels may sum in another order for a weight that requires grad)."""
    return InferenceAgent(cfg, policy.requires_grad_(False), 2, test_augmentation=False)


def _build(cfg, path):
    return InferenceAgent.build(cfg, path, num_streams=2, test_augmentation=False, device="cpu")


def _policy(cfg, seed):
    return SafeVLAPolicy(cfg.model, device="cpu", generator=torch.Generator().manual_seed(seed))


def test_agent_builds_from_port_checkpoints(mcfg, tmp_path):
    """A trainer checkpoint (through its run directory) and a bare params
    export of a seed-3 policy, built by an agent of seed 123: the towers and
    the frozen ViT and T5 are the saved ones, and the acts bit-equal."""
    cfg = _port_cfg(mcfg)
    policy = _policy(cfg, seed=3)
    ts = Learner(policy, cfg).init()
    ckpt.save_checkpoint(str(tmp_path / "run"), ts, 7)
    tree = {"towers": policy.towers.state_dict(), "vit": policy.vit.state_dict(), "t5": policy.t5.state_dict()}
    export = ckpt.save_checkpoint(str(tmp_path / "export"), tree, 1)
    want = _acts(_agent(cfg, policy))
    fresh = _policy(cfg, seed=123)
    for path in (str(tmp_path / "run"), export):
        agent = _build(cfg, path)
        for name in ("vit", "t5"):
            live = getattr(agent.policy, name).state_dict()
            assert all(torch.equal(live[k], v) for k, v in getattr(policy, name).state_dict().items())
            assert not all(torch.equal(live[k], v) for k, v in getattr(fresh, name).state_dict().items())
        assert _same_acts(_acts(agent), want), path


@pytest.mark.parametrize("container", ["raw", "allenact", "lightning"])
def test_agent_builds_from_reference_containers(mcfg, tmp_path, container):
    """A reference torch file holds towers only: the agent takes them and
    keeps its own (seeded) ViT and T5, so it acts bit-equal to an agent over
    a policy of its seed with those towers."""
    cfg = _port_cfg(mcfg)
    policy = _policy(cfg, seed=123)
    with torch.no_grad():
        for p in policy.towers.parameters():
            p.add_(0.01 * torch.randn(p.shape, generator=torch.Generator().manual_seed(p.numel())))
    sd = {}
    for (_, prefix), tower in zip(convert.TOWER_PREFIXES, policy.towers):
        sd.update({prefix + k: v for k, v in tower.state_dict().items()})
    if container == "allenact":
        sd = {"model_state_dict": sd}
    elif container == "lightning":
        il = lambda k: "actor." + k[len("actor.linear."):] if k.startswith("actor.linear.") else k
        sd = {"state_dict": {"model." + il(k): v for k, v in sd.items()}}
    torch.save(sd, tmp_path / "ref.pt")
    assert _same_acts(_acts(_build(cfg, str(tmp_path / "ref.pt"))), _acts(_agent(cfg, policy)))


def test_foreign_tree_raises(mcfg, tmp_path):
    cfg = _port_cfg(mcfg)
    path = ckpt.save_checkpoint(str(tmp_path / "junk"), {"weights": torch.ones(3)}, 1)
    with pytest.raises(ValueError, match="not a recognized"):
        ckpt.restore_policy_params(path, _policy(cfg, seed=0))
    with pytest.raises(ValueError, match="not a recognized"):
        _build(cfg, path)


def test_checkpoint_without_frozen_encoders_still_restores(mcfg, tmp_path):
    """A trainer checkpoint of the format before the frozen encoders were
    saved: its towers restore, the ViT and T5 keep the built policy's."""
    cfg = _port_cfg(mcfg)
    policy = _policy(cfg, seed=3)
    path = ckpt.save_checkpoint(str(tmp_path / "run"), Learner(policy, cfg).init(), 4)
    payload = torch.load(f"{path}/train_state.pt", weights_only=True)
    del payload["frozen_params"]
    torch.save(payload, f"{path}/train_state.pt")
    agent = _build(cfg, path)
    fresh = _policy(cfg, seed=123)
    for a, b in zip(agent.policy.towers.state_dict().values(), policy.towers.state_dict().values()):
        assert torch.equal(a, b)
    for a, b in zip(agent.policy.vit.state_dict().values(), fresh.vit.state_dict().values()):
        assert torch.equal(a, b)
    target = Learner(fresh, cfg).init()
    vit = {k: v.clone() for k, v in target.frozen_params["vit"].items()}
    restored = ckpt.restore_checkpoint(path, target)
    assert all(torch.equal(restored.frozen_params["vit"][k], v) for k, v in vit.items())
    for a, b in zip(restored.tower_params.values(), policy.towers.parameters()):
        assert torch.equal(a, b)
