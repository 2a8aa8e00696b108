"""Per-task reward shapers (reference training/online/reward/reward_shaper.py)."""

from __future__ import annotations

from typing import List

import numpy as np


class RewardShaper:
    def __init__(self, task) -> None:
        self.task = task
        self.task_info = task.task_info
        self.reward_config = task.reward_config
        self.action_names = task.action_names
        self.controller = task.controller
        self._rewards: List[float] = []
        self.distance_type = None
        self.dist_to_target_func = None

    def shaping(self) -> float:
        raise NotImplementedError


class ObjectNavRewardShaper(RewardShaper):
    """Distance-progress shaping + failed-action penalty
    (reference reward_shaper.py:34-66)."""

    def __init__(self, task) -> None:
        super().__init__(task)
        self.distance_type = task.distance_type
        self.dist_to_target_func = task.dist_to_target_func
        self.closest_distance = self.dist_to_target_func()
        self.num_failed_actions = 0

    def shaping(self) -> float:
        if self.reward_config is None or self.reward_config.shaping_weight == 0.0:
            return 0
        reward = 0.0
        cur = self.dist_to_target_func()
        if self.distance_type == "l2":
            reward += self.reward_config.shaping_weight * max(
                self.closest_distance - cur, 0
            )
            self.closest_distance = min(self.closest_distance, cur)
        if not self.task.last_action_success and not self.task._took_end_action:
            self.num_failed_actions += 1
            reward += self.reward_config.failed_action_penalty
        return reward


class FetchRewardShaper(RewardShaper):
    """Arm-distance progress + one-time pickup/pickupable bonuses (+5 each)
    (reference reward_shaper.py:69-178)."""

    def __init__(self, task) -> None:
        super().__init__(task)
        self.distance_type = task.distance_type
        self.last_distance_from_arm = self.min_l2_distance_to_target_from_arm()
        d = self.min_l2_distance_to_target_colliders_from_arm()
        self.last_distance_from_arm_to_colliders = d
        self.closest_distance_from_arm_to_colliders = d
        self._took_pickup_action = False
        self.got_reward_for_pickup = False
        self.got_reward_for_pickupable = False

    def _target_object_ids(self):
        object_type = self.task_info["synsets"][0]
        return self.task_info["synset_to_object_ids"][object_type]

    def is_object_pickupable(self) -> bool:
        in_sphere = self.controller.get_objects_in_hand_sphere()
        return any(oid in in_sphere for oid in self._target_object_ids())

    def min_l2_distance_to_target_from_arm(self) -> float:
        dists = [
            self.controller.dist_from_arm_sphere_center_to_obj(oid)
            for oid in self._target_object_ids()
        ]
        return min(dists) if dists else -1.0

    def min_l2_distance_to_target_colliders_from_arm(self) -> float:
        dists = [
            self.controller.dist_from_arm_sphere_center_to_obj_colliders_closest_to_point(oid)
            for oid in self._target_object_ids()
        ]
        return min(dists) if dists else -1.0

    def shaping(self) -> float:
        if self.reward_config is None or self.reward_config.shaping_weight == 0.0:
            return 0
        reward = 0.0
        if (
            not self.got_reward_for_pickup
            and self._took_pickup_action
            and self.task.successful_if_done()
        ):
            reward += 5.0
            self.got_reward_for_pickup = True
        if not self.got_reward_for_pickupable and self.is_object_pickupable():
            reward += 5.0
            self.got_reward_for_pickupable = True
        cur = self.min_l2_distance_to_target_colliders_from_arm()
        if self.distance_type == "l2":
            reward += (
                self.reward_config.shaping_weight
                * 5
                * max(self.closest_distance_from_arm_to_colliders - cur, 0)
            )
            self.closest_distance_from_arm_to_colliders = min(
                self.closest_distance_from_arm_to_colliders, cur
            )
        return reward


class RoomVisitRewardShaper(RewardShaper):
    """Exploration shaping: new-location + new-room + sub_done bonuses
    (reference reward_shaper.py:181-232)."""

    def __init__(self, task) -> None:
        super().__init__(task)
        self.reachable_positions = self.controller.get_reachable_positions()
        self.reachable_locations = np.array(
            [[p["x"], p["z"]] for p in self.reachable_positions]
        ).round(1)

    def get_agent_loc(self):
        pos = self.controller.get_current_agent_position()
        return round(pos["x"], 1), round(pos["z"], 1)

    def shaping(self) -> float:
        if self.reward_config is None or self.reward_config.shaping_weight == 0.0:
            return 0
        reward = 0.0
        if len(self.task.seen_rooms) > self.task.last_num_seen_rooms:
            self.task.last_num_seen_rooms = len(self.task.seen_rooms)
        idx = (
            ((self.reachable_locations - np.array(self.get_agent_loc())) ** 2)
            .sum(axis=1)
            .argmin()
        )
        cur_loc = tuple(self.reachable_locations[idx])
        if cur_loc not in self.task.visited_loc:
            reward += 0.005
            self.task.visited_loc.add(cur_loc)
        if self.task.get_current_room() not in self.task.visited_rooms:
            reward += 2.0
            self.task.visited_rooms.add(self.task.get_current_room())
        if self.task._took_sub_done_action:
            reward += 2.0 if self.task.last_action_success else -0.2
        return reward * self.reward_config.shaping_weight
