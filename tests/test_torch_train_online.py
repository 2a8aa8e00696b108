"""Online training through its entry point on the CPU: the port's
`launch.py` and `cli/train_online.py` against the JAX package's, the
evaluation CLI on the checkpoint they write, and `profile_trace`.

* `launch.make_fake_sampler_factory` of several task types: the specs of
  each stream equal JAX's, and an EnvPool over each package's factory,
  driven by the same fixed actions, gives the same rewards, costs, done
  flags and episode metrics (so `reward_config_for`, also compared field by
  field, shapes them alike);
* `cli.train_online.main(["--smoke", "train.task_type=FetchType",
  "model.critic_type=discrete", ...], device="cpu")` runs the async pipeline
  to its total steps and writes a checkpoint, its logged metrics finite and
  its value losses HL-Gauss cross-entropies; the sync trainer with the mlp
  critic as well; without `device="cpu"` on a machine with no card it
  raises;
* without `--fake-env`, on the mock AI2-THOR backend
  (`tests/torch_thor_mock.py`): `launch.make_thor_sampler_factory` over an
  Hdf5TaskSpecs directory and a houses directory against JAX's, as the fake
  factory is held, then `cli.train_online` trains on those streams;
* `cli.evaluate.main` restores that checkpoint and evaluates FetchType rows
  (episodes capped at 12 steps, as `tests/test_torch_evaluation.py` does)."""

import dataclasses
import functools
import gzip
import json
import os
import random
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import safevla_tpu.launch as jlaunch
import safevla_tpu.tasks.base as jax_task_base
import safevla_tpu_torch.tasks.base as task_base
import torch_port_tiny as tiny
import torch_thor_mock as thor_mock
from safevla_tpu.config import Config as JaxConfig
from safevla_tpu.rollout.env_pool import EnvPool as JaxEnvPool
from safevla_tpu_torch import config as pconfig
from safevla_tpu_torch import launch
from safevla_tpu_torch.cli import evaluate as eval_cli
from safevla_tpu_torch.cli import train_online
from safevla_tpu_torch.config import Config, ModelConfig, apply_overrides
from safevla_tpu_torch.envs.fake_controller import FakeController
from safevla_tpu_torch.evaluation import types as ptypes
from safevla_tpu_torch.rollout.env_pool import EnvPool
from safevla_tpu_torch.utils.profiling import profile_trace

STREAMS = 3
# moves, turns, a pickup and `end` (index 4) every 7th step
ACTIONS = [[(3 * t + s) % 4 if t % 7 != 6 else 4 for s in range(STREAMS)] for t in range(20)]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    yield from tiny.one_torch_thread()


def _configs(task_type):
    jcfg, pcfg = JaxConfig(), Config()
    for cfg in (jcfg, pcfg):
        cfg.train.task_type = task_type
        cfg.train.max_steps = 8
        cfg.model = dataclasses.replace(cfg.model, image_size=(28, 42))
    return jcfg, pcfg


def test_reward_config_for_matches_jax():
    jcfg, pcfg = _configs("FetchType")
    jcfg.train.collision_penalty = pcfg.train.collision_penalty = -0.1
    got, want = launch.reward_config_for(pcfg), jlaunch.reward_config_for(jcfg)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.failed_action_penalty == -0.1


@pytest.mark.parametrize("task_type", ["ObjectNavType", "FetchType", "PickupType", "ObjectNavMulti"])
def test_fake_sampler_factory_matches_jax(task_type, monkeypatch):
    clock = SimpleNamespace(time=lambda: 1.7e9)
    monkeypatch.setattr(jax_task_base, "time", clock)
    monkeypatch.setattr(task_base, "time", clock)
    jcfg, pcfg = _configs(task_type)
    runs = {}
    for name, factory, pool_cls in (("jax", jlaunch.make_fake_sampler_factory(jcfg), JaxEnvPool),
                                    ("port", launch.make_fake_sampler_factory(pcfg), EnvPool)):
        specs = [factory(i).task_spec_sampler.house_index_to_task_specs for i in range(STREAMS)]
        random.seed(5)
        np.random.seed(5)
        pool = pool_cls(factory, num_streams=STREAMS, num_workers=0)
        steps = [pool.initial_steps()] + [pool.step(a) for a in ACTIONS]
        pool.close()
        runs[name] = specs, [[(s.reward, s.cost, s.done, s.new_episode, s.metrics) for s in row] for row in steps]
    assert runs["port"][0] == runs["jax"][0]
    assert all(spec["task_type"] == task_type for specs in runs["port"][0] for spec in specs[0])
    assert runs["port"][1] == runs["jax"][1]
    assert sum(s[2] for row in runs["port"][1] for s in row) >= STREAMS  # episodes ended


def test_config_takes_the_cli_overrides():
    cfg = apply_overrides(Config(), ["train.task_type=FetchType", "model.critic_type=discrete",
                                     "train.collision_penalty=-0.1", "train.metric_accumulate_interval=10"])
    assert (cfg.train.task_type, cfg.model.critic_type) == ("FetchType", "discrete")
    assert cfg.train.collision_penalty == -0.1 and cfg.train.metric_accumulate_interval == 10
    jax_train = {f.name: f.default for f in dataclasses.fields(JaxConfig().train) if f.name != "stages"}
    port_train = {f.name: f.default for f in dataclasses.fields(Config().train) if f.name != "stages"}
    assert port_train == jax_train


def _metrics(run_dir):
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


@pytest.fixture(scope="module")
def smoke_run(tmp_path_factory):
    """`cli.train_online --smoke` with FetchType and the discrete critic
    (the async pipeline, Config()'s default): 3 windows of 4 x 8 steps."""
    out = tmp_path_factory.mktemp("train_online")
    random.seed(0)
    np.random.seed(0)
    ts = train_online.main(["--smoke", "train.task_type=FetchType", "model.critic_type=discrete",
                            "train.total_steps=64", f"train.output_dir={out}"], device="cpu")
    return out, ts


def test_train_online_cli_smoke(smoke_run):
    out, ts = smoke_run
    run_dir = os.path.join(out, Config().train.tag)
    assert ts.step == 96  # as in JAX: one window past the first boundary at or above 64
    assert os.path.isfile(os.path.join(run_dir, "step_96", "train_state.pt"))
    logs = _metrics(run_dir)
    assert [m["step"] for m in logs] == [32, 64, 96] and all(m["train/async"] for m in logs)
    for m in logs:
        assert all(np.isfinite(v) for v in m.values() if isinstance(v, float)), m
        assert m["train/value"] > 0 and m["train/c_value"] > 0  # HL-Gauss cross-entropies
    assert ts.tower_params["1.critic.fc.2.weight"].shape[0] == Config().model.hl_gauss_bins


def test_train_online_cli_sync_mlp(tmp_path):
    ts = train_online.main(["--smoke", "train.task_type=PickupType", "model.critic_type=mlp",
                            "train.async_pipeline=false", "train.total_steps=32",
                            f"train.output_dir={tmp_path}"], device="cpu")
    run_dir = os.path.join(tmp_path, Config().train.tag)
    assert ts.step == 32 and os.path.isfile(os.path.join(run_dir, "step_32", "train_state.pt"))
    (log,) = _metrics(run_dir)
    assert "train/async" not in log and all(np.isfinite(v) for v in log.values() if isinstance(v, float))
    assert ts.tower_params["2.critic.fc.4.weight"].shape == (1, 256)


def test_train_online_cli_needs_the_card_unless_asked_for_the_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default device trains there")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_online.main(["--smoke", f"train.output_dir={tmp_path}"])


def _write_thor_data(root, houses):
    """`houses` in `<root>/houses/train.jsonl.gz` and an Hdf5TaskSpecs
    directory `<root>/specs/train/<house>/hdf5_sensors.hdf5` of ObjectNav
    specs over each house's objects (three per house)."""
    import h5py

    from safevla_tpu_torch.utils.string_codec import convert_string_to_byte

    os.makedirs(root / "houses")
    with gzip.open(root / "houses" / "train.jsonl.gz", "wt") as f:
        f.writelines(json.dumps(h) + "\n" for h in houses)
    for hi, house in enumerate(houses):
        os.makedirs(root / "specs" / "train" / f"{hi:06d}")
        with h5py.File(root / "specs" / "train" / f"{hi:06d}" / "hdf5_sensors.hdf5", "w") as f:
            for j, row in enumerate(thor_mock.objectnav_rows(house, hi, 3)):
                spec = {k: row[k] for k in ("task_type", "synsets", "synset_to_object_ids",
                                            "broad_synset_to_object_ids", "natural_language_spec")}
                spec["extras"] = {}
                text = json.dumps(spec)
                grp = f.create_group(str(j))
                grp.create_dataset("templated_task_spec", data=convert_string_to_byte(text, 2 * len(text)).reshape(1, -1))
                grp.create_dataset("house_index", data=np.full((1,), hi, np.int64))
                x, y, z = row["agent_starting_position"]
                grp.create_dataset("last_agent_location", data=np.array([[x, y, z, 0.0, row["agent_y_rotation"], 0.0]]))
    return str(root / "specs"), str(root / "houses")


@pytest.fixture
def thor_env(monkeypatch):
    """The mock AI2-THOR backend, rendering 28 x 44 frames (cropped to the
    tiny policies' 28 x 42), and a fixed clock for the task ids."""
    from safevla_tpu.envs import thor_controller as jthor
    from safevla_tpu_torch.envs import thor_controller as pthor

    thor_mock.install(thor_mock.ModuleSetter(monkeypatch))
    for thor in (jthor, pthor):
        monkeypatch.setattr(thor, "default_thor_env_args",
                            functools.partial(thor.default_thor_env_args, height=28, width=44))
    clock = SimpleNamespace(time=lambda: 1.7e9)
    monkeypatch.setattr(jax_task_base, "time", clock)
    monkeypatch.setattr(task_base, "time", clock)


def test_train_online_cli_in_thor_houses(thor_env, tmp_path, tiny_model_cfg, monkeypatch):
    """Without `--fake-env`: the THOR sampler factory over an Hdf5TaskSpecs
    directory and a houses directory equals JAX's (the specs of every stream,
    then the same rewards, costs, done flags and metrics under the same
    actions), and `cli.train_online` trains a window on those streams."""
    specs_dir, houses_dir = _write_thor_data(tmp_path, [thor_mock.make_house(s) for s in (1, 2)])
    jcfg, pcfg = _configs("ObjectNavType")
    for cfg in (jcfg, pcfg):
        cfg.train.num_train_processes = 2
    runs = {}
    for name, factory, pool_cls in (
        ("jax", jlaunch.make_thor_sampler_factory(jcfg, specs_dir, houses_dir), JaxEnvPool),
        ("port", launch.make_thor_sampler_factory(pcfg, specs_dir, houses_dir), EnvPool),
    ):
        specs = [factory(i).task_spec_sampler.house_index_to_task_specs for i in range(2)]
        random.seed(5)
        np.random.seed(5)
        pool = pool_cls(factory, num_streams=2, num_workers=0)
        steps = [pool.initial_steps()] + [pool.step(a[:2]) for a in ACTIONS]
        pool.close()
        runs[name] = specs, [[(s.reward, s.cost, s.done, s.new_episode, s.metrics) for s in row] for row in steps]
        assert steps[0][0].obs["rgb_raw"].shape == (28, 42, 3)
    assert runs["port"][0] == runs["jax"][0] and set(runs["port"][0][1]) == {1}  # stream 1: house 1
    assert runs["port"][1] == runs["jax"][1]
    assert sum(s[2] for row in runs["port"][1] for s in row) >= 2  # episodes ended

    tiny.register_tiny_vit(monkeypatch)
    model = tiny.model_cfg(tiny_model_cfg)
    monkeypatch.setattr(pconfig, "Config", lambda: Config(ModelConfig(**dataclasses.asdict(model))))
    ts = train_online.main(
        ["--data-dir", specs_dir, "--houses-dir", houses_dir, "--env-workers", "0",
         "train.num_train_processes=2", "ppo.num_steps=8", "train.max_steps=8", "train.total_steps=16",
         "train.async_pipeline=false", f"train.output_dir={tmp_path / 'out'}"],
        device="cpu",
    )
    assert ts.step == 16
    (log,) = _metrics(os.path.join(tmp_path / "out", Config().train.tag))
    assert all(np.isfinite(v) for v in log.values() if isinstance(v, float))


def _smoke_model(critic_type):
    """The model `cli.train_online --smoke` builds (its ViT registered by
    that run)."""
    return ModelConfig(
        hidden_size=64, num_tx_layers=2, num_tx_heads=4, goal_dims=64, text_embed_size=64,
        combiner_layers=1, combiner_heads=4, combiner_ffn_dim=128, dino_compressor_hidden_out_dims=(64, 64),
        vision_backbone="smoke_tiny", vision_feature_dim=32, vision_grid=(7, 12), image_size=(28, 42),
        max_steps=16, text_max_tokens=8, num_towers=3, compute_dtype="float32", critic_type=critic_type,
    )


def test_evaluate_cli_restores_the_checkpoint(smoke_run, tmp_path, monkeypatch):
    out, ts = smoke_run
    objs = FakeController(seed=0).get_objects()
    bench = tmp_path / "fetchtype_val.jsonl.gz"
    with gzip.open(bench, "wt") as f:
        for i in range(3):
            target = objs[i % len(objs)]
            synset = target["objectType"].lower() + ".n.01"
            ids = [o["objectId"] for o in objs if o["objectType"] == target["objectType"]]
            f.write(json.dumps({
                "task_type": "FetchType", "house_index": 0,
                "natural_language_spec": f"fetch a {target['objectType'].lower()}",
                "agent_starting_position": [1.5, 0.9, 3.0], "agent_y_rotation": float(30 * i),
                "expert_length": 10, "synsets": [synset], "synset_to_object_ids": {synset: ids},
                "broad_synset_to_object_ids": {synset: ids},
            }) + "\n")
    monkeypatch.setattr(pconfig, "Config", lambda: Config(_smoke_model("discrete")))
    # episodes of 12 steps at most, not the benchmark's: the size of the test
    monkeypatch.setitem(ptypes.MAX_EPISODE_LEN_PER_TASK, "FetchType", 12)
    results = eval_cli.main(
        ["--ckpt", os.path.join(out, Config().train.tag), "--benchmark", str(bench), "--task-type",
         "FetchType", "--fake-env", "eval.num_workers=2", "eval.test_augmentation=false",
         f"train.output_dir={tmp_path}"],
        device="cpu",
    )
    assert results["task_type"] == "FetchType" and results["num_episodes"] == 3
    assert all(r["ep_length"] >= 1 and np.isfinite(float(r["cost"])) for r in results["safety_table"])
    assert all(np.isfinite(v) for v in results["aggregate"].values())


def test_profile_trace_writes_a_trace(tmp_path):
    with profile_trace(str(tmp_path / "trace"), with_python=True):
        torch.ones(4).add_(1)
    (name,) = os.listdir(tmp_path / "trace")
    with open(tmp_path / "trace" / name) as f:
        assert "traceEvents" in json.load(f)
