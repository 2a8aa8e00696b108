"""Run assembly: data roots + config -> sampler factories.

Copy of `safevla_tpu/launch.py` (the glue the reference spreads across
`BaseConfig.machine_params` / `task_sampler_args_builder` / `make_sampler_fn`,
reference training/online/base.py:135-336): load houses and task specs,
partition them across rollout streams, and build per-stream samplers bound to
the AI2-THOR simulator's `StretchController` (`make_thor_sampler_factory`,
what `cli/train_online.py` runs by default), or to FakeController for
simulator-free runs (`make_fake_sampler_factory`, `--fake-env`).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

from safevla_tpu_torch.config import Config
from safevla_tpu_torch.constants import ALL_STRETCH_ACTIONS
from safevla_tpu_torch.data.stores import Hdf5TaskSpecs, LazyJsonHouses
from safevla_tpu_torch.envs.sensors import default_train_sensors
from safevla_tpu_torch.tasks import MultiTaskSampler, TaskSpecSamplerInfiniteList
from safevla_tpu_torch.types import RewardConfig


def reward_config_for(cfg: Config) -> RewardConfig:
    """reference dinov2_vits_tsfm_base.py:100-110."""
    return RewardConfig(
        step_penalty=0.0,
        goal_success_reward=10.0,
        failed_stop_reward=0.0,
        shaping_weight=0.0,
        reached_horizon_reward=0.0,
        positive_only_reward=False,
        failed_action_penalty=cfg.train.collision_penalty,
    )


def partition_specs_by_house(specs) -> Dict[int, List[dict]]:
    by_house: Dict[int, List[dict]] = {}
    for spec in specs:
        by_house.setdefault(int(spec["house_index"]), []).append(spec)
    return by_house


def thor_controller():
    """(StretchController, default_thor_env_args) of the AI2-THOR simulator;
    `ai2thor` itself is imported when a controller or its arguments are built."""
    from safevla_tpu_torch.envs.thor_controller import StretchController, default_thor_env_args

    return StretchController, default_thor_env_args


def make_thor_sampler_factory(
    cfg: Config,
    task_spec_dataset_dir,
    houses_dir: Optional[str] = None,
    mode: str = "train",
    max_houses: Optional[int] = None,
) -> Callable[[int], Any]:
    """Per-stream factory for real AI2-THOR training.

    Each stream loads its round-robin shard of the task specs (reference
    base.py:284-320 partitions Hdf5TaskSpecs by proc id) and drives its own
    simulator process. `task_spec_dataset_dir` may be a single dataset dir, a
    list of dirs, or a named mixture (safevla_tpu_torch.data.mixtures) resolved
    under a root dir as `<root>/<TaskType>` — mixed task types interleave in
    each stream's per-house spec pool (multi-task constrained RL).
    """
    if isinstance(task_spec_dataset_dir, str):
        dataset_dirs = [task_spec_dataset_dir]
    else:
        dataset_dirs = list(task_spec_dataset_dir)
    return ThorSamplerFactory(cfg, dataset_dirs, houses_dir or cfg.objaverse_houses_dir, mode, max_houses)


class ThorSamplerFactory:
    """`make_thor_sampler_factory`'s factory: an object rather than JAX's
    closure, so that the env pool's worker processes (forkserver) can be
    handed it and build their stream's sampler themselves."""

    def __init__(self, cfg: Config, dataset_dirs: List[str], houses_dir: str, mode: str,
                 max_houses: Optional[int]):
        self.cfg, self.dataset_dirs, self.houses_dir = cfg, dataset_dirs, houses_dir
        self.mode, self.max_houses = mode, max_houses
        self.num_streams = cfg.train.num_train_processes

    def __call__(self, stream_id: int):
        cfg, mode = self.cfg, self.mode
        controller_type, thor_env_args = thor_controller()
        houses = LazyJsonHouses.from_dir(self.houses_dir, subset=mode, max_lines=self.max_houses)
        all_specs: List[dict] = []
        for d in self.dataset_dirs:
            all_specs.extend(
                Hdf5TaskSpecs.from_dataset_dir(
                    d, subset=mode, proc_id=stream_id, total_procs=self.num_streams
                )
            )
        by_house = partition_specs_by_house(all_specs)
        house_inds = sorted(by_house.keys())
        return MultiTaskSampler(
            mode=mode,
            task_args=dict(
                sensors=default_train_sensors(
                    rgb_height=cfg.model.image_size[0],
                    rgb_width=cfg.model.image_size[1],
                    traj_max_idx=cfg.model.traj_max_idx,
                ),
                max_steps=cfg.train.max_steps,
                action_names=ALL_STRETCH_ACTIONS,
                reward_config=reward_config_for(cfg) if mode == "train" else None,
            ),
            houses=[houses[i] for i in house_inds],
            house_inds=house_inds,
            controller_args=thor_env_args(),
            controller_type=controller_type,
            task_spec_sampler=TaskSpecSamplerInfiniteList(
                by_house,
                shuffle=mode == "train",
                repeat_house_until_forced=mode == "train",
            ),
            prob_randomize_materials=0.8 if mode == "train" else 0.0,
        )


def make_fake_sampler_factory(
    cfg: Config, episode_max_steps: Optional[int] = None
) -> Callable[[int], Any]:
    """Simulator-free streams (FakeController) of `cfg.train.task_type`, for
    smoke runs & benchmarks."""
    from safevla_tpu_torch.envs.fake_controller import FakeController

    h, w = cfg.model.image_size
    max_steps = episode_max_steps or min(cfg.train.max_steps, 100)

    def factory(stream_id: int):
        controller = FakeController(seed=stream_id, image_height=h, image_width=w)
        objs = controller.get_objects()
        target = objs[stream_id % len(objs)]
        synset = target["objectType"].lower() + ".n.01"
        ids = [o["objectId"] for o in objs if o["objectType"] == target["objectType"]]
        spec = {
            "task_type": cfg.train.task_type,
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
                sensors=default_train_sensors(rgb_height=h, rgb_width=w),
                max_steps=max_steps,
                action_names=ALL_STRETCH_ACTIONS,
                reward_config=reward_config_for(cfg),
            ),
            houses=[{"rooms": [{}, {}]}],
            house_inds=[0],
            controller_args={"seed": stream_id, "image_height": h, "image_width": w},
            controller_type=FakeController,
            task_spec_sampler=TaskSpecSamplerInfiniteList(
                {0: [spec]}, shuffle=True, repeat_house_until_forced=True
            ),
            controller=controller,
        )

    return factory
