"""Multi-target and room navigation tasks.

The reference registers params + instruction templates + eval budgets for
ObjectNavMulti and RoomNav (utils/type_utils.py:200-234,
max_episode_configs.py, task_spec_to_instruction.py object_nav_multi /
room_nav) and its dynamic-instruction sensor reads `task.found_target_idx`
(navigation_sensors.py:144-184) — but the task classes live outside the repo.
These implementations complete the family with those contracts:

  * ObjectNavMultiTask: visit each target synset IN ORDER; `sub_done` marks
    the current target found (visible within 2m), `done` ends the episode;
    success when every synset was found in order.
  * RoomNavTask: navigate into a room of the target type; success when the
    agent's current room id is one of the spec's room ids (or matches the
    requested room type).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np

from safevla_tpu_torch.tasks.base import SPOCTask
from safevla_tpu_torch.tasks.object_nav import ObjectNavTask
from safevla_tpu_torch.tasks.registry import register_task
from safevla_tpu_torch.types import RewardConfig, THORActions


@register_task
class ObjectNavMultiTask(ObjectNavTask):
    task_type_str = "ObjectNavMulti"

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.found_target_idx: List[int] = []
        self._took_sub_done_action = False

    def _current_target_synset(self) -> Optional[str]:
        synsets = self.task_info["synsets"]
        nxt = len(self.found_target_idx)
        return synsets[nxt] if nxt < len(synsets) else None

    def _synset_visible(self, synset: str) -> bool:
        ids = self.task_info["broad_synset_to_object_ids"].get(synset, [])
        return any(
            self.controller.object_is_visible_in_camera(
                oid, which_camera="nav", maximum_distance=2
            )
            for oid in ids
        )

    def _step(self, action: int):
        action_str = self.action_names[action]
        if action_str == THORActions.sub_done:
            target = self._current_target_synset()
            found = target is not None and self._synset_visible(target)
            result = super()._step(action)
            if found:
                self.found_target_idx.append(len(self.found_target_idx))
                self.last_action_success = True
            return result
        return super()._step(action)

    def successful_if_done(self, strict_success: bool = False) -> bool:
        synsets = self.task_info["synsets"]
        remaining = synsets[len(self.found_target_idx) :]
        if len(remaining) > 1:
            return False
        if len(remaining) == 1:
            return self._synset_visible(remaining[0])
        return True


@register_task
class RoomNavTask(SPOCTask):
    task_type_str = "RoomNav"

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
        self.target_room_ids = sum(task_info.get("room_ids", {}).values(), [])
        self.target_room_types = [t.lower() for t in task_info.get("room_types", [])]

    def successful_if_done(self, strict_success: bool = False) -> bool:
        room = self.get_current_room()
        if room is None:
            return False
        if self.target_room_ids and room in self.target_room_ids:
            return True
        room_type = self.controller.room_type_dict.get(room, "").lower()
        return bool(self.target_room_types) and room_type in self.target_room_types

    def judge(self) -> float:
        if self.reward_config is None:
            return 0
        reward = self.reward_config.step_penalty
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
        c = self.cost_tracker.cumulative
        metrics["cost_danger"] = c.danger
        metrics["cost_corner"] = c.corner
        metrics["cost_critical"] = c.critical
        metrics["cost_fragile"] = c.fragile
        metrics["cost_blind"] = c.blind
        metrics["cost"] = self.cumulative_cost
        self._metrics = metrics
        return metrics
