"""ObjectNav task family (reference tasks/object_nav_task.py)."""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np

from safevla_tpu_torch.tasks.base import SPOCTask
from safevla_tpu_torch.tasks.registry import register_task
from safevla_tpu_torch.tasks.rewards import ObjectNavRewardShaper
from safevla_tpu_torch.types import RewardConfig
from safevla_tpu_torch.utils.metrics import position_dist, spl_metric


@register_task
class ObjectNavTask(SPOCTask):
    """Navigate until the target object type is visible within 2m of the
    navigation camera, then issue `done`."""

    task_type_str = "ObjectNavType"

    def __init__(
        self,
        controller,
        sensors,
        task_info: Dict[str, Any],
        max_steps: int,
        action_names: List[str],
        reward_config: Optional[RewardConfig] = None,
        distance_type: str = "l2",
        visualize: Optional[bool] = None,
        house: Optional[Dict[str, Any]] = None,
        **kwargs,
    ) -> None:
        super().__init__(
            controller=controller,
            sensors=sensors,
            task_info=task_info,
            max_steps=max_steps,
            action_names=action_names,
            reward_config=reward_config,
            house=house,
            visualize=visualize,
            **kwargs,
        )
        self._rewards: List[float] = []
        self.distance_type = distance_type
        self.dist_to_target_func = self.min_l2_distance_to_target

        if self.task_info.get("synset_to_object_ids") is None:
            self.task_info["synset_to_object_ids"] = {
                synset: [
                    o["objectId"]
                    for o in self.controller.get_all_objects_of_synset(
                        synset=synset, include_hyponyms=True
                    )
                ]
                for synset in self.task_info["synsets"]
            }

        last_distance = self.dist_to_target_func()
        self.closest_distance = last_distance
        self.optimal_distance = self.min_geodesic_distance_to_target()

        self.reward_shaper = (
            ObjectNavRewardShaper(task=self) if reward_config is not None else None
        )

    # ------------------------------------------------------------------
    def _target_object_ids(self) -> List[str]:
        return sum(
            map(list, self.task_info["broad_synset_to_object_ids"].values()), []
        )

    def min_l2_distance_to_target(self) -> float:
        agent = self.controller.get_current_agent_position()
        dists = [
            position_dist(self.controller.get_obj_pos_from_obj_id(oid), agent)
            for oid in self._target_object_ids()
        ]
        return min(dists) if dists else -1.0

    def min_geodesic_distance_to_target(self) -> float:
        _, min_dist = self.controller.get_closest_object_from_ids(
            object_ids=self._target_object_ids(), return_id_and_dist=True
        )
        return min_dist

    def successful_if_done(self, strict_success: bool = False) -> bool:
        object_type = self.task_info["synsets"][0]
        visible = [
            oid
            for oid in self.task_info["broad_synset_to_object_ids"][object_type]
            if self.controller.object_is_visible_in_camera(
                oid, which_camera="nav", maximum_distance=2
            )
        ]
        return len(visible) > 0

    def shaping(self) -> float:
        if self.reward_config is None:
            return 0
        return self.reward_shaper.shaping()

    def judge(self) -> float:
        """Reward for the last step (reference object_nav_task.py:142-159)."""
        if self.reward_config is None:
            return 0
        reward = self.reward_config.step_penalty
        reward += self.shaping()
        if self._took_end_action:
            reward += (
                self.reward_config.goal_success_reward
                if self._success
                else self.reward_config.failed_stop_reward
            )
        elif self.num_steps_taken() + 1 >= self.max_steps:
            reward += self.reward_config.reached_horizon_reward
        self._rewards.append(float(reward))
        return float(reward)

    def metrics(self) -> Dict[str, Any]:
        if not self.is_done():
            return {}
        metrics = super().metrics()
        metrics["ep_length"] = self.num_steps_taken()
        metrics["dist_to_target"] = self.dist_to_target_func()
        metrics["total_reward"] = float(np.sum(self._rewards))
        c = self.cost_tracker.cumulative
        metrics["cost_danger"] = c.danger
        metrics["cost_corner"] = c.corner
        metrics["cost_critical"] = c.critical
        metrics["cost_fragile"] = c.fragile
        metrics["cost_blind"] = c.blind
        metrics["cost"] = self.cumulative_cost
        spl = spl_metric(
            success=bool(self._success),
            optimal_distance=self.optimal_distance,
            travelled_distance=self.travelled_distance,
        )
        metrics["spl"] = 0.0 if spl is None or np.isnan(spl) else spl
        metrics["success"] = self._success
        if self.reward_shaper is not None:
            n_failed = self.reward_shaper.num_failed_actions
            metrics["num_failed_actions"] = n_failed
            metrics["percentage_collision"] = (
                100 * n_failed / (1e-9 + self.num_steps_taken())
            )
            metrics["has_collision"] = n_failed > 0
        self._metrics = metrics
        return metrics


@register_task
class EasyObjectNavTask(ObjectNavTask):
    task_type_str = "EasyObjectNavType"


@register_task
class ObjectNavRoomTask(ObjectNavTask):
    task_type_str = "ObjectNavRoom"


@register_task
class ObjectNavRelAttributeTask(ObjectNavTask):
    task_type_str = "ObjectNavRelAttribute"


@register_task
class ObjectNavLocalRefTask(ObjectNavTask):
    task_type_str = "ObjectNavLocalRef"


@register_task
class ObjectNavAffordanceTask(ObjectNavTask):
    task_type_str = "ObjectNavAffordance"


@register_task
class ObjectNavDescriptionTask(ObjectNavTask):
    task_type_str = "ObjectNavDescription"
