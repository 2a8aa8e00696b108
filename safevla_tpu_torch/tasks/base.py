"""Episode lifecycle base class for SPOC-style tasks.

Counterpart of the reference's `AbstractSPOCTask`
(reference: tasks/abstract_task.py:78-468) with no engine dependency: the
rollout runtime calls `step(action_index)` and receives a `StepResult`
carrying reward AND safety cost. All safety detection is delegated to
`CostTracker` (tasks/cost_model.py).
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional

import numpy as np

from safevla_tpu_torch.tasks.cost_model import CostTracker
from safevla_tpu_torch.types import RewardConfig, StepResult, THORActions
from safevla_tpu_torch.utils.metrics import (
    position_dist,
    sel_metric,
    trajectory_room_visitation,
)


class SPOCTask:
    task_type_str: Optional[str] = None

    def __init__(
        self,
        controller,
        sensors,
        task_info: Dict[str, Any],
        max_steps: int,
        action_names: List[str],
        reward_config: Optional[RewardConfig] = None,
        house: Optional[Dict[str, Any]] = None,
        collect_observations: bool = True,
        task_sampler=None,
        visualize: Optional[bool] = None,
        **kwargs,
    ) -> None:
        self.controller = controller
        self.sensors = sensors
        self.task_info = task_info
        self.max_steps = max_steps
        self.action_names = action_names
        self.reward_config = reward_config
        self.house = house
        self.collect_observations = collect_observations
        self.task_sampler = task_sampler
        self.visualize = visualize

        self._num_steps_taken = 0
        self._took_end_action = False
        self._took_sub_done_action = False
        self._success: Optional[bool] = False
        self.last_action_success: Any = -1
        self.last_action_random: Any = -1
        self.last_taken_action_str = ""
        self.error_message = ""
        self._metrics = None
        self._observation_cache = None
        self.observation_history: List[Any] = []

        self.cost_tracker = CostTracker()
        self.primary_objs: List[Dict[str, Any]] = []

        self.path: List[Dict[str, float]] = []
        self.travelled_distance = 0.0

        assert (
            task_info.get("extras") == {}
        ), "task_info['extras'] must exist (empty) and is reserved for runtime info"

        self.objects = self.controller.get_objects()
        self.room_poly_map = getattr(controller, "room_poly_map", {})
        self.room_type_dict = getattr(controller, "room_type_dict", {})
        self.visited_and_left_rooms = set()
        self.previous_room = None
        self.rooms_visited_history: List[Any] = []

        self.task_info["followed_path"] = [controller.get_current_agent_position()]
        self.task_info["agent_poses"] = [controller.get_current_agent_full_pose()]
        self.task_info["taken_actions"] = []
        self.task_info["action_successes"] = []
        self.task_info["id"] = (
            f"{task_info['task_type']}_{task_info['house_index']}_{int(time.time())}"
        )
        if "natural_language_spec" in task_info:
            self.task_info["id"] += "_" + task_info["natural_language_spec"].replace(" ", "")

    # ------------------------------------------------------------------
    def num_steps_taken(self) -> int:
        return self._num_steps_taken

    def is_done(self) -> bool:
        return self.reached_terminal_state() or self._num_steps_taken >= self.max_steps

    def reached_terminal_state(self) -> bool:
        return self._took_end_action

    def is_successful(self) -> bool:
        return self.successful_if_done() and self._took_end_action

    def successful_if_done(self, strict_success: bool = False) -> bool:
        raise NotImplementedError

    def judge(self) -> float:
        raise NotImplementedError

    def close(self) -> None:
        pass

    @property
    def cumulative_cost(self):
        return self.cost_tracker.cumulative_cost

    # ------------------------------------------------------------------
    def get_observations(self) -> Optional[Dict[str, Any]]:
        if not self.collect_observations:
            return None
        if self._observation_cache is None:
            self._observation_cache = {
                s.uuid: s.get_observation(self.controller, self) for s in self.sensors
            }
        return self._observation_cache

    def record_observations(self):
        assert (
            len(self.observation_history) == 0 and self._num_steps_taken == 0
        ) or len(self.observation_history) == self._num_steps_taken, (
            "record_observations must be called exactly once per step"
        )
        self.observation_history.append(self.get_observations())

    def get_current_room(self):
        pos = self.controller.get_current_agent_position()
        return self.controller.get_room_id_from_location(pos)

    def step_with_action_str(self, action_name: str, is_random: bool = False):
        assert action_name in self.action_names
        self.last_action_random = is_random
        return self.step(self.action_names.index(action_name))

    # ------------------------------------------------------------------
    def step(self, action: int) -> StepResult:
        if self._num_steps_taken == 0:
            self.record_observations()
        action_str = self.action_names[action]

        current_room = self.get_current_room()
        if current_room is not None:
            self.rooms_visited_history.append(current_room)
        if current_room != self.previous_room and current_room is not None:
            if self.previous_room is not None:
                self.visited_and_left_rooms.add(self.previous_room)
            self.previous_room = current_room

        self.controller.reset_visibility_cache()
        self._observation_cache = None

        result = self._step(action)
        self._num_steps_taken += 1
        self.record_observations()

        position = self.controller.get_current_agent_position()
        self.task_info["taken_actions"].append(action_str)
        self.task_info["followed_path"].append(position)
        self.task_info["agent_poses"].append(self.controller.get_current_agent_full_pose())
        self.task_info["action_successes"].append(self.last_action_success)
        return result

    def _step(self, action: int) -> StepResult:
        action_str = self.action_names[action]
        self.last_taken_action_str = action_str
        collided = False
        cost = 0

        if action_str == THORActions.done:
            self._took_end_action = True
            self._success = self.successful_if_done()
            self.last_action_success = self._success
        elif action_str == THORActions.sub_done:
            self._took_sub_done_action = True
            self.last_action_success = False
        else:
            primary_objs = self.primary_objs
            update_objs = self.controller.get_objects()
            self.primary_objs = update_objs

            event = self.controller.agent_step(action=action_str)
            self.error_message = event.metadata["errorMessage"].lower()
            self.last_action_success = bool(event)
            collided = event.metadata.get("collided", False)

            position = self.controller.get_current_agent_position()
            self.path.append(position)
            if len(self.path) > 1:
                self.travelled_distance += position_dist(
                    self.path[-1], self.path[-2], ignore_y=True
                )

            breakdown = self.cost_tracker.step(
                primary_objs=primary_objs,
                update_objs=update_objs,
                error_message=self.error_message,
                agent_position=position,
                visible_object_names=self.controller.get_visible_objects(
                    maximum_distance=4
                ),
                get_reachable_xz=lambda: [
                    (p["x"], p["z"]) for p in self.controller.get_reachable_positions()
                ],
            )
            cost = breakdown.cost

        return StepResult(
            observation=self.get_observations(),
            reward=self.judge(),
            cost=cost,
            done=self.is_done(),
            info={
                "last_action_success": self.last_action_success,
                "action": action,
                "collided": collided,
                "errorMessage": self.error_message,
            },
        )

    # ------------------------------------------------------------------
    def metrics(self) -> Dict[str, Any]:
        if not self.is_done():
            return {}
        metrics: Dict[str, Any] = {}
        metrics["success"] = self._success
        metrics["cost"] = self.cumulative_cost
        metrics["task_info"] = self.task_info
        sel = (
            sel_metric(
                success=bool(self._success),
                optimal_episode_length=self.task_info["expert_length"],
                actual_episode_length=self.num_steps_taken(),
            )
            if "expert_length" in self.task_info
            else 0
        )
        metrics["sel"] = 0.0 if sel is None or np.isnan(sel) else sel
        if self.room_poly_map:
            pct, tot = trajectory_room_visitation(
                self.controller.get_room_id_from_location,
                self.task_info["followed_path"],
                len(self.room_poly_map),
            )
        else:
            pct, tot = 0, 0
        metrics["percentage_rooms_visited"] = pct
        metrics["total_rooms_visited"] = tot
        # fraction of failed actions, a collision proxy
        # (reference online_evaluator_worker.py:546-553)
        succ = [s for s in self.task_info["action_successes"] if s != -1]
        metrics["percentage_collision"] = 1 - sum(map(bool, succ)) / (1e-9 + len(succ))
        if self.visualize:
            # overhead render of the followed path, shipped with the episode
            # metrics for the evaluator's video/table output (reference
            # online_evaluator_worker.py:395-403 top_down_frame)
            render = getattr(self.controller, "get_top_down_path_view", None)
            if render is not None:
                try:
                    metrics["top_down_frame"] = np.asarray(
                        render(self.task_info["followed_path"])[0]
                    )
                except Exception:
                    pass
        if len(self.task_info.get("synsets", [])) == 1:
            self._extra_per_obj_metrics(metrics)
        self._metrics = metrics
        return metrics

    def _extra_per_obj_metrics(self, metrics: Dict[str, Any]):
        """Per-object diagnostic metrics, incl. failure analysis: did the
        agent at least reach the target's room / see target pixels
        (reference online_evaluator_worker.py:418-485)."""
        object_type = self.task_info["synsets"][0]
        metrics[f"extra/{object_type}/success"] = metrics["success"]
        metrics[f"extra/{object_type}/ep_length"] = self.num_steps_taken()
        if metrics["success"]:
            return
        metrics[f"extra/{object_type}/when_failed_visited_obj_room"] = (
            self._visited_target_room(object_type)
        )
        for cam in ("nav", "manip"):
            key = f"num_pixels_visible_{cam}"
            vals = [
                int(np.asarray(o[key]).reshape(-1)[0])
                for o in self.observation_history
                if o is not None and key in o
            ]
            if vals:
                metrics[
                    f"extra/{object_type}/when_failed_max_visible_pixels_{cam}"
                ] = max(vals)

    def _visited_target_room(self, object_type: str) -> bool:
        get_room = getattr(self.controller, "get_objects_room_id_and_type", None)
        if get_room is None:
            return False
        target_rooms = set()
        for oid in self.task_info.get("synset_to_object_ids", {}).get(object_type, []):
            try:
                target_rooms.add(get_room(oid)[0])
            except Exception:
                pass
        target_rooms.discard(None)
        return bool(target_rooms & set(self.rooms_visited_history))

    def add_extra_task_information(self, key, value):
        assert key not in self.task_info["extras"], "extras keys are write-once"
        self.task_info["extras"][key] = value

    def to_dict(self):
        return self.task_info
