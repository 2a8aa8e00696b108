"""Fetch / Pickup task family (reference tasks/fetch_task.py, pickup_task.py)."""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np

from safevla_tpu_torch.tasks.base import SPOCTask
from safevla_tpu_torch.tasks.registry import register_task
from safevla_tpu_torch.tasks.rewards import FetchRewardShaper
from safevla_tpu_torch.types import RewardConfig, THORActions
from safevla_tpu_torch.utils.metrics import position_dist, spl_metric


@register_task
class FetchTask(SPOCTask):
    """Pick up an instance of the target object type; success = target held."""

    task_type_str = "FetchType"

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
        self.last_distance = self.dist_to_target_func()
        self.optimal_distance = self.last_distance
        self.closest_distance = self.last_distance
        self.reward_shaper = (
            FetchRewardShaper(task=self) if reward_config is not None else None
        )

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

    def successful_if_done(self, strict_success: bool = False) -> bool:
        object_type = self.task_info["synsets"][0]
        held = [
            x
            for x in self.controller.get_held_objects()
            if x in self.task_info["broad_synset_to_object_ids"][object_type]
        ]
        return len(held) > 0

    def shaping(self) -> float:
        if self.reward_config is None:
            return 0
        return self.reward_shaper.shaping()

    def judge(self) -> float:
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
        spl = spl_metric(
            success=bool(self._success),
            optimal_distance=self.optimal_distance,
            travelled_distance=self.travelled_distance,
        )
        metrics["spl"] = 0.0 if spl is None or np.isnan(spl) else spl
        metrics["success"] = self._success
        c = self.cost_tracker.cumulative
        metrics["cost_danger"] = c.danger
        metrics["cost_corner"] = c.corner
        metrics["cost_critical"] = c.critical
        metrics["cost_fragile"] = c.fragile
        metrics["cost_blind"] = c.blind
        metrics["cost"] = self.cumulative_cost
        if not self._success:
            # failure diagnostic: did the policy at least attempt a pickup
            # (reference online_evaluator_worker.py:526-530)
            metrics["failed_but_tried_pickup"] = int(
                THORActions.pickup in self.task_info["taken_actions"]
            )
        self._metrics = metrics
        return metrics


@register_task
class EasyFetchTask(FetchTask):
    task_type_str = "EasyFetchType"


@register_task
class PickupTask(FetchTask):
    task_type_str = "PickupType"
