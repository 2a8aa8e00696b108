"""Sensor suite: observation extractors over (controller, task).

Counterparts of the reference's AllenAct `Sensor` classes
(reference: environment/vision_sensors.py, navigation_sensors.py,
manipulation_sensors.py) with no gym/allenact dependency: a sensor is an
object with `uuid` and `get_observation(controller, task) -> np.ndarray`.

The two stateful sensors reproduce the reference's deferred-increment
protocol exactly (it is what makes packed-rollout masks line up):
  * TimeStepSensor (navigation_sensors.py:985-1014): in-episode step index;
    +1 compensation because the observation for step t is produced before the
    step counter increments.
  * TrajectorySensor (navigation_sensors.py:1017-1042): per-sampler episode
    counter mod max_idx, incremented on the first observation after a done.
"""

from __future__ import annotations

import random
from typing import Any, List, Optional

import numpy as np

from safevla_tpu_torch.utils.string_codec import convert_string_to_byte


class Sensor:
    def __init__(self, uuid: str):
        self.uuid = uuid

    def get_observation(self, env, task) -> Any:
        raise NotImplementedError


class RawNavigationStretchRGBSensor(Sensor):
    def __init__(self, uuid: str = "rgb_raw", height: int = 224, width: int = 384):
        super().__init__(uuid)
        self.height, self.width = height, width

    def get_observation(self, env, task) -> np.ndarray:
        return env.navigation_camera


class RawManipulationStretchRGBSensor(Sensor):
    def __init__(
        self, uuid: str = "manipulation_rgb_raw", height: int = 224, width: int = 384
    ):
        super().__init__(uuid)
        self.height, self.width = height, width

    def get_observation(self, env, task) -> np.ndarray:
        return env.manipulation_camera


class TimeStepSensor(Sensor):
    def __init__(self, uuid: str = "time_step", max_time_for_random_shift: int = 0):
        super().__init__(uuid)
        self.max_time_for_random_shift = max_time_for_random_shift
        self.random_start = 0
        self._update = False

    def sample_random_start(self):
        self.random_start = random.randint(0, max(self.max_time_for_random_shift, 0))

    def get_observation(self, env, task) -> np.ndarray:
        steps = task.num_steps_taken()
        if self._update:
            steps += 1
        else:
            self._update = True
        if task.is_done():
            self._update = False
            self.sample_random_start()
        return np.array(self.random_start + int(steps), dtype=np.int64)


class TrajectorySensor(Sensor):
    def __init__(self, uuid: str = "traj_index", max_idx: int = 2048):
        super().__init__(uuid)
        self.curr_idx = 0
        self.max_idx = max_idx
        self._update = False

    def get_observation(self, env, task) -> np.ndarray:
        if self._update:
            self.curr_idx = (self.curr_idx + 1) % self.max_idx
            self._update = False
        if task.is_done():
            self._update = True
        return np.array(self.curr_idx, dtype=np.int64)


class TaskNaturalLanguageSpecSensor(Sensor):
    def __init__(self, uuid: str = "natural_language_spec", str_max_len: int = 1000):
        super().__init__(uuid)
        self.str_max_len = str_max_len

    def get_observation(self, env, task) -> np.ndarray:
        goal = task.task_info.get("natural_language_spec", "")
        return convert_string_to_byte(goal, self.str_max_len)


class AnObjectIsInHand(Sensor):
    def __init__(self, uuid: str = "an_object_is_in_hand"):
        super().__init__(uuid)

    def get_observation(self, env, task) -> np.ndarray:
        return np.array([len(env.get_held_objects()) > 0], dtype=np.int64)


class RelativeArmLocationMetadata(Sensor):
    def __init__(self, uuid: str = "relative_arm_location_metadata"):
        super().__init__(uuid)

    def get_observation(self, env, task) -> np.ndarray:
        return np.array(env.get_arm_proprioception(), dtype=np.float64)


class TargetObjectWasPickedUp(Sensor):
    def __init__(self, uuid: str = "target_obj_was_pickedup"):
        super().__init__(uuid)

    def get_observation(self, env, task) -> np.ndarray:
        target_in_hand = False
        if "synsets" in task.task_info:
            object_ids: List[str] = []
            for object_type in task.task_info["synsets"]:
                object_ids += task.task_info["synset_to_object_ids"].get(object_type, [])
            held = env.get_held_objects()
            target_in_hand = any(x in object_ids for x in held)
        return np.array([target_in_hand], dtype=np.int64)


class ExpertPickupableSensor(Sensor):
    """Binary expert signal for the Imitation BCE aux loss (reference
    customized_loss.py:17-83 reads observation uuid 'expert_pickupable'):
    1.0 when a target object is currently within the hand's pickup sphere,
    i.e. the expert would issue the pickup action now."""

    def __init__(self, uuid: str = "expert_pickupable"):
        super().__init__(uuid)

    def get_observation(self, env, task) -> np.ndarray:
        pickupable = False
        if "synsets" in task.task_info:
            object_ids: List[str] = []
            for object_type in task.task_info["synsets"]:
                object_ids += task.task_info["synset_to_object_ids"].get(object_type, [])
            in_sphere = env.get_objects_in_hand_sphere()
            pickupable = any(x in object_ids for x in in_sphere)
        return np.array(pickupable, dtype=np.float64)


class ReadyForDoneActionSensor(Sensor):
    def __init__(self, uuid: str = "expert_done"):
        super().__init__(uuid)

    def get_observation(self, env, task) -> np.ndarray:
        return np.array(task.successful_if_done(), dtype=np.float64)


class ReadyForSubDoneActionSensor(Sensor):
    def __init__(self, uuid: str = "expert_subdone"):
        super().__init__(uuid)

    def get_observation(self, env, task) -> np.ndarray:
        seen = getattr(task, "seen_rooms", set())
        return np.array(task.get_current_room() not in seen, dtype=np.float64)


class LastActionSuccessSensor(Sensor):
    def __init__(self, uuid: str = "last_action_success"):
        super().__init__(uuid)

    def get_observation(self, env, task) -> np.ndarray:
        return np.array([1 if task.last_action_success else 0], dtype=np.int64)


class LastAgentLocationSensor(Sensor):
    def __init__(self, uuid: str = "last_agent_location"):
        super().__init__(uuid)

    def get_observation(self, env, task) -> np.ndarray:
        pose = env.get_current_agent_full_pose()
        p, r = pose["position"], pose["rotation"]
        return np.array(
            [p["x"], p["y"], p["z"], r["x"], r["y"], r["z"]], dtype=np.float64
        )


def default_train_sensors(
    rgb_height: int = 224,
    rgb_width: int = 384,
    traj_max_idx: int = 2048,
    use_text_goal: bool = True,
    full_sensor: bool = True,
) -> List[Sensor]:
    """The online-RL sensor set (reference dinov2_vits_tsfm_base.py:171-209)."""
    sensors: List[Sensor] = [
        RawNavigationStretchRGBSensor(uuid="rgb_raw", height=rgb_height, width=rgb_width),
        TimeStepSensor(uuid="time_step", max_time_for_random_shift=0),
        TrajectorySensor(uuid="traj_index", max_idx=traj_max_idx),
    ]
    if use_text_goal:
        sensors.append(TaskNaturalLanguageSpecSensor(uuid="natural_language_spec"))
    if full_sensor:
        sensors += [
            RawManipulationStretchRGBSensor(
                uuid="manipulation_rgb_raw", height=rgb_height, width=rgb_width
            ),
            AnObjectIsInHand(uuid="an_object_is_in_hand"),
        ]
    return sensors


class TaskTemplatedTextSpecSensor(Sensor):
    """JSON-templated task spec as fixed-width bytes
    (reference navigation_sensors.py:102-141)."""

    def __init__(self, uuid: str = "templated_task_spec", str_max_len: int = 2000):
        super().__init__(uuid)
        self.str_max_len = str_max_len

    def get_observation(self, env, task) -> np.ndarray:
        import json

        from safevla_tpu_torch.types import REGISTERED_TASK_PARAMS

        info = task.task_info
        keys = REGISTERED_TASK_PARAMS.get(info.get("task_type", ""), [])
        subset = {k: info[k] for k in keys if k in info}
        subset["task_type"] = info.get("task_type")
        subset["extras"] = info.get("extras", {})
        return convert_string_to_byte(json.dumps(subset, default=str), self.str_max_len)


class LastActionIsRandomSensor(Sensor):
    def __init__(self, uuid: str = "last_action_is_random"):
        super().__init__(uuid)

    def get_observation(self, env, task) -> np.ndarray:
        return np.array([1 if task.last_action_random == True else 0], dtype=np.int64)  # noqa: E712


class LastActionStrSensor(Sensor):
    """Previous action's short code as bytes (reference l.726-742)."""

    def __init__(self, uuid: str = "last_action_str", str_max_len: int = 20):
        super().__init__(uuid)
        self.str_max_len = str_max_len

    def get_observation(self, env, task) -> np.ndarray:
        return convert_string_to_byte(task.last_taken_action_str, self.str_max_len)


class HouseNumberSensor(Sensor):
    def __init__(self, uuid: str = "house_index"):
        super().__init__(uuid)

    def get_observation(self, env, task) -> np.ndarray:
        return np.array([int(task.task_info.get("house_index", -1))], dtype=np.int64)


class MinL2TargetDistanceSensor(Sensor):
    """Current L2 distance to the closest target (reference l.706-723)."""

    def __init__(self, uuid: str = "minimum_l2_target_distance"):
        super().__init__(uuid)

    def get_observation(self, env, task) -> np.ndarray:
        fn = getattr(task, "dist_to_target_func", None)
        return np.array([fn() if fn else -1.0], dtype=np.float64)


class HypotheticalTaskSuccessSensor(Sensor):
    """Would `done` succeed right now? (reference l.186-201)."""

    def __init__(self, uuid: str = "hypothetical_task_success"):
        super().__init__(uuid)

    def get_observation(self, env, task) -> np.ndarray:
        return np.array([task.successful_if_done()], dtype=np.int64)


class RoomsSeenSensor(Sensor):
    def __init__(self, uuid: str = "rooms_seen"):
        super().__init__(uuid)

    def get_observation(self, env, task) -> np.ndarray:
        return np.array([len(getattr(task, "seen_rooms", set()))], dtype=np.int64)


class RoomCurrentSeenSensor(Sensor):
    """Whether the current room has been seen before (reference l.793-808)."""

    def __init__(self, uuid: str = "room_current_seen"):
        super().__init__(uuid)

    def get_observation(self, env, task) -> np.ndarray:
        room = task.get_current_room()
        return np.array(
            [room in getattr(task, "seen_rooms", set())], dtype=np.int64
        )


class CurrentAgentRoom(Sensor):
    """Index of the room the agent currently occupies (reference l.811-830)."""

    def __init__(self, uuid: str = "current_agent_room"):
        super().__init__(uuid)

    def get_observation(self, env, task) -> np.ndarray:
        room = task.get_current_room()
        rooms = sorted(getattr(env, "room_poly_map", {}).keys())
        return np.array(
            [rooms.index(room) if room in rooms else -1], dtype=np.int64
        )


class Visible4mTargetCountSensor(Sensor):
    """How many target instances are visible within 4m (reference l.239-264)."""

    def __init__(self, uuid: str = "visible_target_4m_count"):
        super().__init__(uuid)

    def get_observation(self, env, task) -> np.ndarray:
        count = 0
        info = task.task_info
        for synset in info.get("synsets", []):
            for oid in info.get("synset_to_object_ids", {}).get(synset, []):
                if env.object_is_visible_in_camera(oid, which_camera="nav", maximum_distance=4):
                    count += 1
        return np.array([count], dtype=np.int64)


class MinimumTargetAlignmentSensor(Sensor):
    """Smallest |yaw offset| (deg) to any target instance visible within 2m
    in the nav camera; -1 when none visible (reference
    navigation_sensors.py:204-236)."""

    def __init__(self, uuid: str = "minimum_visible_target_alignment"):
        super().__init__(uuid)

    def get_observation(self, env, task) -> np.ndarray:
        info = task.task_info
        if "synsets" not in info:
            return np.array([-1], dtype=np.float64)
        object_type = info["synsets"][0]
        alignments = [
            abs(env.get_agent_alignment_to_object(oid))
            for oid in info["synset_to_object_ids"][object_type]
            if env.object_is_visible_in_camera(
                oid, which_camera="nav", maximum_distance=2
            )
        ]
        if not alignments:
            return np.array([-1], dtype=np.float64)
        return np.array([min(alignments)], dtype=np.float64)


class GoalObjectTypeSensor(Sensor):
    """Categorical index of the (single) goal object type
    (reference navigation_sensors.py:763-773: GoalObjectTypeThorSensor
    subclass returning object_type_to_ind[task_info['synsets'][0]])."""

    def __init__(self, object_types: List[str], uuid: str = "goal_object_type_ind"):
        super().__init__(uuid)
        self.object_types = list(object_types)
        self.object_type_to_ind = {t: i for i, t in enumerate(self.object_types)}

    def get_observation(self, env, task) -> np.ndarray:
        synsets = task.task_info["synsets"]
        assert len(synsets) == 1, (
            f"GoalObjectTypeSensor requires exactly one goal synset, got {synsets}"
        )
        return np.array(self.object_type_to_ind[synsets[0]], dtype=np.int64)


class NumPixelsVisible(Sensor):
    """Pixel count of the target's segmentation mask
    (reference navigation_sensors.py:833-870)."""

    def __init__(self, uuid: str = "num_pixels_visible", which_camera: str = "nav"):
        super().__init__(uuid)
        self.which_camera = which_camera

    def get_observation(self, env, task) -> np.ndarray:
        total = 0
        get_mask = getattr(env, "get_segmentation_mask_of_object", None)
        if get_mask is not None:
            info = task.task_info
            for synset in info.get("synsets", []):
                for oid in info.get("synset_to_object_ids", {}).get(synset, []):
                    try:
                        total += int(get_mask(oid, which_camera=self.which_camera).sum())
                    except Exception:
                        pass
        return np.array([total], dtype=np.int64)
