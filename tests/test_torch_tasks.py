"""The port's task families (`safevla_tpu_torch/tasks/{fetch,room_visit,
multi_nav,probe}.py`) against the JAX package's, step by step.

For each task type the port adds to the ObjectNav family, a JAX task and a
port task are built from the same spec on FakeControllers of the same seed
(28x42 frames, reward shaping and a failed-action penalty on) and driven by
the same fixed action sequence, once ending by `done` and once running to
max_steps: the observation, reward, cost, done flag and action success of
every step, and the final `metrics()`, must be equal (floats within 1e-6).
A task's id ends in the wall-clock second it began, so both packages read
one fixed clock."""

import random
from types import SimpleNamespace

import numpy as np
import pytest

import safevla_tpu.tasks as jtasks
import safevla_tpu.tasks.base as jax_task_base
import safevla_tpu_torch.tasks as ptasks
import safevla_tpu_torch.tasks.base as task_base
from safevla_tpu.envs.fake_controller import FakeController as JaxFakeController
from safevla_tpu.envs.sensors import default_train_sensors as jax_sensors
from safevla_tpu.types import RewardConfig as JaxRewardConfig
from safevla_tpu_torch.constants import ALL_STRETCH_ACTIONS
from safevla_tpu_torch.envs.fake_controller import FakeController
from safevla_tpu_torch.envs.sensors import default_train_sensors
from safevla_tpu_torch.types import RewardConfig, THORActions

NEW_TYPES = ["FetchType", "EasyFetchType", "PickupType", "RoomVisit", "ObjectNavMulti", "RoomNav",
             "ConstrainedBandit", "InstructionBandit"]
SIDES = {
    "jax": SimpleNamespace(tasks=jtasks, base=jax_task_base, controller=JaxFakeController,
                           sensors=jax_sensors, reward=JaxRewardConfig),
    "port": SimpleNamespace(tasks=ptasks, base=task_base, controller=FakeController,
                            sensors=default_train_sensors, reward=RewardConfig),
}
HW = (28, 42)
MAX_STEPS = 12
A = THORActions
_SEQ = [A.move_ahead, A.rotate_left, A.move_ahead, A.pickup, A.sub_done, A.rotate_right, A.move_ahead,
        A.move_back, A.rotate_left, A.pickup, A.move_ahead, A.sub_done]
ACTIONS = {
    "ends_by_done": [ALL_STRETCH_ACTIONS.index(a) for a in _SEQ[:7] + [A.done]],
    "runs_to_max_steps": [ALL_STRETCH_ACTIONS.index(a) for a in _SEQ],
}


def test_registry_has_the_jax_task_types():
    assert sorted(ptasks.REGISTERED_TASKS) == sorted(jtasks.REGISTERED_TASKS)
    assert set(NEW_TYPES) <= set(ptasks.REGISTERED_TASKS)
    assert sorted(ptasks.__all__) == sorted(jtasks.__all__)


def _spec(controller, task_type):
    """A spec of `task_type` over the controller's objects: two target
    synsets for ObjectNavMulti, one for the fetch family."""
    objs = controller.get_objects()
    types = list(dict.fromkeys(o["objectType"] for o in objs))[:2]
    synsets = [t.lower() + ".n.01" for t in types]
    ids = {s: [o["objectId"] for o in objs if o["objectType"] == t] for s, t in zip(synsets, types)}
    spec = {"task_type": task_type, "house_index": 0, "natural_language_spec": f"find a {types[0].lower()}",
            "agent_starting_position": [1.5, 0.9, 3.0], "agent_y_rotation": 0.0}
    if task_type == "RoomVisit":
        spec["num_rooms_in_house"] = 2
    elif task_type == "RoomNav":
        spec.update(room_types=["Kitchen"], room_ids={})
    elif task_type == "InstructionBandit":
        spec["natural_language_spec"] = "turn right"
    elif task_type != "ConstrainedBandit":
        keep = synsets if task_type == "ObjectNavMulti" else synsets[:1]
        spec.update(synsets=keep, synset_to_object_ids={s: ids[s] for s in keep},
                    broad_synset_to_object_ids={s: ids[s] for s in keep})
    return spec


def _run(side, task_type, actions, seed):
    random.seed(seed)
    np.random.seed(seed)
    controller = side.controller(seed=seed, image_height=HW[0], image_width=HW[1])
    task_info = side.tasks.MultiTaskSampler.task_spec_to_task_info(
        _spec(controller, task_type), 0, {"rooms": [{}, {}]}
    )
    task_info["extras"] = {}
    task = side.tasks.REGISTERED_TASKS[task_type](
        controller=controller,
        sensors=side.sensors(rgb_height=HW[0], rgb_width=HW[1]),
        task_info=task_info,
        max_steps=MAX_STEPS,
        action_names=ALL_STRETCH_ACTIONS,
        reward_config=side.reward(shaping_weight=1.0, step_penalty=-0.01, failed_action_penalty=-0.05),
    )
    steps = []
    for a in actions:
        if task.is_done():
            break
        r = task.step(a)
        steps.append((r.observation, r.reward, r.cost, r.done, r.info["last_action_success"]))
    assert task.is_done()
    return steps, task.metrics()


def _assert_same(got, want, where):
    if isinstance(want, dict):
        assert got.keys() == want.keys(), where
        for k in want:
            _assert_same(got[k], want[k], f"{where}.{k}")
    elif isinstance(want, (float, np.floating)):
        assert abs(float(got) - float(want)) <= 1e-6, (where, got, want)
    elif isinstance(want, np.ndarray):
        assert np.array_equal(np.asarray(got), want), where
    else:
        assert got == want, (where, got, want)


@pytest.mark.parametrize("ending", sorted(ACTIONS))
@pytest.mark.parametrize("task_type", NEW_TYPES)
def test_task_steps_match_jax(task_type, ending, monkeypatch):
    clock = SimpleNamespace(time=lambda: 1.7e9)
    for side in SIDES.values():
        monkeypatch.setattr(side.base, "time", clock)
    seed = 3 + NEW_TYPES.index(task_type)
    want_steps, want_metrics = _run(SIDES["jax"], task_type, ACTIONS[ending], seed)
    got_steps, got_metrics = _run(SIDES["port"], task_type, ACTIONS[ending], seed)
    assert len(got_steps) == len(want_steps) == len(ACTIONS[ending])
    for t, ((go, *g), (wo, *w)) in enumerate(zip(got_steps, want_steps)):
        _assert_same(go, wo, f"step {t} observation")
        _assert_same(tuple(g), tuple(w), f"step {t} (reward, cost, done, success)")
    assert got_metrics and got_metrics.get("ep_length") == len(ACTIONS[ending])
    _assert_same(got_metrics, want_metrics, "metrics")


@pytest.mark.parametrize("max_steps,cost_limit", [(8, 2.0), (16, 4.0), (4, 10.0)])
def test_constrained_bandit_optima_match_jax(max_steps, cost_limit):
    got = ptasks.ConstrainedBanditTask.optima(max_steps, cost_limit)
    assert got == jtasks.ConstrainedBanditTask.optima(max_steps, cost_limit)
    assert got["safe_only_return"] <= got["constrained_return"] <= got["unconstrained_return"]
