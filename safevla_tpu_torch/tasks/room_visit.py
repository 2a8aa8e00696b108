"""RoomVisit (house exploration) task.

The reference registers RoomVisit task params (utils/type_utils.py:236-239),
maps the legacy name "SimpleExploreHouse" to it
(utils/task_type_mapping_utils.py), budgets it 1000 eval steps
(online_evaluation/max_episode_configs.py) and ships its reward shaper
(reward_shaper.py:181-232) — but the task class itself lives outside the repo.
This implementation provides the attributes that shaper contract requires
(seen_rooms / visited_rooms / visited_loc / last_num_seen_rooms) with
success = all rooms of the house visited.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np

from safevla_tpu_torch.tasks.base import SPOCTask
from safevla_tpu_torch.tasks.registry import register_task
from safevla_tpu_torch.tasks.rewards import RoomVisitRewardShaper
from safevla_tpu_torch.types import RewardConfig


@register_task
class RoomVisitTask(SPOCTask):
    task_type_str = "RoomVisit"

    def __init__(
        self,
        controller,
        sensors,
        task_info: Dict[str, Any],
        max_steps: int,
        action_names: List[str],
        reward_config: Optional[RewardConfig] = None,
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
        self.seen_rooms = set()
        self.visited_rooms = set()
        self.visited_loc = set()
        self.last_num_seen_rooms = 0
        self.num_rooms_in_house = task_info.get(
            "num_rooms_in_house", len(getattr(controller, "room_poly_map", {})) or 1
        )
        self.reward_shaper = (
            RoomVisitRewardShaper(task=self) if reward_config is not None else None
        )

    def successful_if_done(self, strict_success: bool = False) -> bool:
        return len(self.visited_rooms) >= self.num_rooms_in_house

    def shaping(self) -> float:
        if self.reward_config is None:
            return 0
        return self.reward_shaper.shaping()

    def judge(self) -> float:
        if self.reward_config is None:
            return 0
        reward = self.reward_config.step_penalty
        room = self.get_current_room()
        if room is not None:
            self.seen_rooms.add(room)
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
        metrics["total_reward"] = float(np.sum(self._rewards))
        metrics["rooms_visited"] = len(self.visited_rooms)
        metrics["num_rooms_in_house"] = self.num_rooms_in_house
        c = self.cost_tracker.cumulative
        metrics["cost_danger"] = c.danger
        metrics["cost_corner"] = c.corner
        metrics["cost_critical"] = c.critical
        metrics["cost_fragile"] = c.fragile
        metrics["cost_blind"] = c.blind
        metrics["cost"] = self.cumulative_cost
        self._metrics = metrics
        return metrics
