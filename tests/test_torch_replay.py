"""Trace record/replay across the two packages (`envs/replay_controller.py`).

* A trace the JAX package's `RecordingController` writes on a FakeController
  episode replays through the port's `ReplayController` and task stack with
  rewards and costs equal to the live run's, and the reverse; both packages
  write the same trace bytes for the same episode.
* The port's replay raises on an action that diverges from the trace, as
  `tests/test_trace_replay.py` checks JAX's.
* On the mock AI2-THOR backend, the port records a `StretchController`
  episode (rooms and a teleport, which JAX's recorder cannot write) and
  replays it with the live rewards and costs.
"""

import gzip
import random
from types import SimpleNamespace

import numpy as np
import pytest

import safevla_tpu.tasks.base as jax_task_base
import safevla_tpu_torch.tasks.base as task_base
import torch_thor_mock as mock
from safevla_tpu.envs import fake_controller as jfake
from safevla_tpu.envs import replay_controller as jrep
from safevla_tpu.tasks import REGISTERED_TASKS as JAX_TASKS
from safevla_tpu.types import RewardConfig as JaxRewardConfig
from safevla_tpu_torch.constants import ALL_STRETCH_ACTIONS
from safevla_tpu_torch.envs import fake_controller as pfake
from safevla_tpu_torch.envs import replay_controller as prep
from safevla_tpu_torch.tasks import REGISTERED_TASKS
from safevla_tpu_torch.types import RewardConfig

PKGS = {
    "jax": SimpleNamespace(fake=jfake, rep=jrep, tasks=JAX_TASKS, reward=JaxRewardConfig),
    "port": SimpleNamespace(fake=pfake, rep=prep, tasks=REGISTERED_TASKS, reward=RewardConfig),
}
SCRIPT = ["m", "r", "m", "l", "m", "m", "b", "r", "m", "ls", "m", "m", "yp", "zp", "m", "rs", "m"]


@pytest.fixture(autouse=True)
def _fixed_clock(monkeypatch):
    clock = SimpleNamespace(time=lambda: 1.7e9)
    monkeypatch.setattr(jax_task_base, "time", clock)
    monkeypatch.setattr(task_base, "time", clock)


def _spec(objs, idx=0):
    target = objs[idx]
    synset = target["objectType"].lower() + ".n.01"
    ids = [o["objectId"] for o in objs if o["objectType"] == target["objectType"]]
    return {
        "task_type": "ObjectNavType", "house_index": 0,
        "natural_language_spec": f"go to a {target['objectType'].lower()}",
        "agent_starting_position": [1.5, 0.9, 3.0], "agent_y_rotation": 0.0,
        "synsets": [synset], "synset_to_object_ids": {synset: ids},
        "broad_synset_to_object_ids": {synset: ids}, "extras": {},
    }, ids


def _task(pkg, controller, spec):
    return pkg.tasks["ObjectNavType"](
        controller=controller, task_info=dict(spec), sensors=[], max_steps=40,
        action_names=ALL_STRETCH_ACTIONS,
        reward_config=pkg.reward(goal_success_reward=10.0, shaping_weight=1.0, step_penalty=-0.01,
                                 failed_action_penalty=-0.05),
    )


def _run(task, actions):
    rewards, costs = [], []
    for a in actions:
        res = task.step(ALL_STRETCH_ACTIONS.index(a))
        rewards.append(res.reward)
        costs.append(res.cost)
        if res.done:
            break
    return np.array(rewards), np.array(costs)


def _record(pkg, path, seed=3):
    spec, ids = _spec(pkg.fake.FakeController(seed=seed).get_objects())
    rec = pkg.rep.RecordingController(pkg.fake.FakeController(seed=seed), ids)
    rec.reset(scene={"rooms": [{}, {}]})
    r, c = _run(_task(pkg, rec, spec), SCRIPT)
    rec.save(str(path), extra={"rewards": r.tolist(), "costs": c.tolist()})
    return spec, r, c


@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax")])
def test_trace_replays_in_the_other_package(tmp_path, writer, reader):
    path = tmp_path / "trace.jsonl.gz"
    spec, r_live, c_live = _record(PKGS[writer], path)
    assert len(set(r_live.tolist())) > 2  # the shaped rewards vary step by step
    rc = PKGS[reader].rep.ReplayController(str(path))
    actions = rc.remaining_actions()
    assert actions == SCRIPT[: len(actions)]
    r_rep, c_rep = _run(_task(PKGS[reader], rc, spec), actions)
    np.testing.assert_allclose(r_rep, r_live, atol=1e-9)
    np.testing.assert_array_equal(c_rep, c_live)
    assert rc.header["rewards"] == r_live.tolist()


def test_both_packages_write_the_same_trace(tmp_path):
    blobs = {}
    for name, pkg in PKGS.items():
        _record(pkg, tmp_path / f"{name}.jsonl.gz", seed=4)
        with gzip.open(tmp_path / f"{name}.jsonl.gz", "rb") as f:
            blobs[name] = f.read()
    assert blobs["port"] == blobs["jax"]


def test_replay_raises_on_a_divergent_action(tmp_path):
    pkg = PKGS["port"]
    spec, ids = _spec(pfake.FakeController(seed=5).get_objects())
    rec = prep.RecordingController(pfake.FakeController(seed=5), ids)
    rec.reset(scene={"rooms": [{}, {}]})
    _run(_task(pkg, rec, spec), ["m", "r"])
    rec.save(str(tmp_path / "t.jsonl.gz"))
    rc = prep.ReplayController(str(tmp_path / "t.jsonl.gz"))
    with pytest.raises(AssertionError, match="replay divergence"):
        rc.agent_step("b")  # the trace says "m"
    rc.agent_step("m")
    with pytest.raises(AssertionError, match="replay divergence at step 2"):
        _run(_task(pkg, rc, spec), ["l"])


def test_stretch_controller_episode_replays(tmp_path, monkeypatch):
    mock.install(mock.ModuleSetter(monkeypatch))
    from safevla_tpu_torch.envs.thor_controller import StretchController, default_thor_env_args

    house = mock.make_house(1)
    spec = mock.objectnav_rows(house, 0, 1)[0]
    spec = {**spec, "extras": {}}
    ids = spec["synset_to_object_ids"][spec["synsets"][0]]
    random.seed(0)
    rec = prep.RecordingController(StretchController(**default_thor_env_args()), ids)
    rec.reset(house)
    rec.teleport_agent(spec["agent_starting_position"], {"x": 0, "y": spec["agent_y_rotation"], "z": 0})
    script = ["m", "m", "r", "m", "m", "m", "m", "l", "m", "m", "m", "m", "m", "m", "zp", "yp", "wp"]
    r_live, c_live = _run(_task(PKGS["port"], rec, spec), script)
    rec.save(str(tmp_path / "thor.jsonl.gz"))
    teleport = next(c for c in rec.inner.controller.calls if c["action"] == "Teleport")
    assert teleport["forceAction"] is False  # forwarded by keyword

    rc = prep.ReplayController(str(tmp_path / "thor.jsonl.gz"))
    assert set(rc.room_poly_map) == {"room|0", "room|1"}
    assert rc.header["room_type_dict"] == {"room|0": "Kitchen", "room|1": "LivingRoom"}
    r_rep, c_rep = _run(_task(PKGS["port"], rc, spec), rc.remaining_actions())
    assert len(r_rep) == len(script)
    np.testing.assert_allclose(r_rep, r_live, atol=1e-9)
    np.testing.assert_array_equal(c_rep, c_live)
