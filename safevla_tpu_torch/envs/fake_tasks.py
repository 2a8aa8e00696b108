"""Sampler factory of FakeController ObjectNav streams, for the sync trainer
and its benchmarks.

The same streams as the JAX package's sync bench (`bench.py`, which takes
them from `tests/test_rollout_training.py::make_sampler_factory`): stream i
runs a FakeController seeded with i, whose target is the type of its i-th
object (modulo the object count), one spec per house, the online-RL sensor
set at `image_hw`, and `max_steps` steps per episode. The training CLI
(`cli/train_online.py --fake-env`) builds its streams with
`launch.make_fake_sampler_factory` instead: the same streams of any task
type (`cfg.train.task_type`) with the reference's reward config.
"""

from __future__ import annotations

import functools
from typing import Callable, Tuple

from safevla_tpu_torch.constants import ALL_STRETCH_ACTIONS
from safevla_tpu_torch.envs.fake_controller import FakeController
from safevla_tpu_torch.envs.sensors import default_train_sensors
from safevla_tpu_torch.tasks import MultiTaskSampler, TaskSpecSamplerInfiniteList
from safevla_tpu_torch.types import RewardConfig


def make_sampler_factory(
    max_steps: int = 8, image_hw: Tuple[int, int] = (28, 42)
) -> Callable[[int], MultiTaskSampler]:
    """The factory, a partial of a module function, so that env-pool worker
    processes (forkserver) can be handed it."""
    return functools.partial(_sampler, max_steps=max_steps, image_hw=image_hw)


def _sampler(stream_id: int, max_steps: int, image_hw: Tuple[int, int]) -> MultiTaskSampler:
    controller = FakeController(
        seed=stream_id, image_height=image_hw[0], image_width=image_hw[1]
    )
    objs = controller.get_objects()
    target = objs[stream_id % len(objs)]
    synset = target["objectType"].lower() + ".n.01"
    ids = [o["objectId"] for o in objs if o["objectType"] == target["objectType"]]
    spec = {
        "task_type": "ObjectNavType",
        "house_index": 0,
        "natural_language_spec": f"go to a {target['objectType'].lower()}",
        "agent_starting_position": [1.5, 0.9, 3.0],
        "agent_y_rotation": 0.0,
        "synsets": [synset],
        "synset_to_object_ids": {synset: ids},
        "broad_synset_to_object_ids": {synset: ids},
    }
    return MultiTaskSampler(
        mode="train",
        task_args=dict(
            sensors=default_train_sensors(rgb_height=image_hw[0], rgb_width=image_hw[1]),
            max_steps=max_steps,
            action_names=ALL_STRETCH_ACTIONS,
            reward_config=RewardConfig(goal_success_reward=10.0),
        ),
        houses=[{"rooms": [{}, {}]}],
        house_inds=[0],
        controller_args={
            "seed": stream_id, "image_height": image_hw[0], "image_width": image_hw[1],
        },
        controller_type=FakeController,
        task_spec_sampler=TaskSpecSamplerInfiniteList(
            {0: [spec]}, shuffle=True, repeat_house_until_forced=True
        ),
        controller=controller,
    )
