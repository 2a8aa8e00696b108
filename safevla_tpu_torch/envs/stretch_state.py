"""Stretch robot state snapshot, differencing, and coordinate transforms.

Copy of `safevla_tpu/envs/stretch_state.py` (pure numpy).
Counterpart of reference environment/stretch_state.py: a full snapshot of the
robot (base pose, wrist lift/extend/yaw, hand-sphere position, gripper, held
objects), absolute difference between states, tolerance comparison (how the
controller decides whether a spatial action "did anything"), and
world<->agent coordinate transforms (numpy-only; the reference uses
scipy.spatial.transform).
"""

from __future__ import annotations

import math
from typing import Any, Dict, Set, Tuple

import numpy as np


def _rot_y_matrix(deg: float) -> np.ndarray:
    r = math.radians(deg)
    c, s = math.cos(r), math.sin(r)
    # Unity's left-handed y-rotation convention (matches scipy "xyz" euler on y)
    return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])


def wrap_angle_to_pm180(angle: float) -> float:
    """Wrap to (-180, 180] (reference stretch_state.py:10-11)."""
    return (angle + 180) % 360 - 180


def angle_point_to_point(loc_start: Dict[str, float], loc_goal: Dict[str, float]) -> float:
    """Yaw (deg) from loc_start toward loc_goal (reference stretch_state.py:14-18)."""
    vector = (loc_goal["x"] - loc_start["x"], loc_goal["z"] - loc_start["z"])
    return wrap_angle_to_pm180(math.degrees(math.atan2(vector[0], vector[1])))


def convert_world_to_agent_coordinate(
    world_position: Dict[str, float], agent_position: Dict[str, float], agent_y_rotation: float
) -> Dict[str, float]:
    rel = np.array(
        [
            world_position["x"] - agent_position["x"],
            world_position["y"] - agent_position.get("y", 0.0),
            world_position["z"] - agent_position["z"],
        ]
    )
    inv = np.linalg.inv(_rot_y_matrix(agent_y_rotation))
    out = inv @ rel
    return {"x": float(out[0]), "y": float(out[1]), "z": float(out[2])}


def convert_agent_to_world_coordinate(
    agent_frame_position: Dict[str, float],
    agent_position: Dict[str, float],
    agent_y_rotation: float,
) -> Dict[str, float]:
    rel = np.array(
        [agent_frame_position["x"], agent_frame_position["y"], agent_frame_position["z"]]
    )
    out = _rot_y_matrix(agent_y_rotation) @ rel
    return {
        "x": float(out[0] + agent_position["x"]),
        "y": float(out[1] + agent_position.get("y", 0.0)),
        "z": float(out[2] + agent_position["z"]),
    }


class StretchState:
    """Snapshot of the Stretch robot (reference stretch_state.py:21-120)."""

    arm_extreme_values = {
        "lift_max": 1.0457,
        "lift_min": -0.055,
        "lift_soft_min": 0.0,
        "extend_max": 0.759,
        "extend_min": 0.243,
    }
    hand_length = 0.20
    hand_height = 0.07
    wrist_rotation_bounds = (75, 100)
    agent_center_y_height = 0.9009982347488403
    max_interactable_height = 1.2

    def __init__(self, controller=None):
        if controller is not None:
            if hasattr(controller, "controller"):
                controller = controller.controller
            meta = controller.last_event.metadata
            agent = meta["agent"]
            arm = meta["arm"]
            joints = arm["joints"]
            wrist = joints[-1]
            assert wrist["name"] == "stretch_robot_wrist_2_jnt"
            lift = joints[0]["rootRelativePosition"]["y"]
            extend = wrist["rootRelativePosition"]["z"]
            yaw = math.fmod(
                wrist["rootRelativeRotation"]["w"] * wrist["rootRelativeRotation"]["y"],
                360,
            )
            hand = arm["handSphereCenter"]
            self._base_position = {
                "x": agent["position"]["x"],
                "y": self.agent_center_y_height,
                "z": agent["position"]["z"],
                "theta": agent["rotation"]["y"],
            }
            self._wrist_pose = {"y": lift, "z": extend, "yaw": yaw}
            self._hand_position = {"x": hand["x"], "y": hand["y"], "z": hand["z"]}
            self._gripper_openness = 0.0
            self._held_oids = set((True, oid) for oid in (arm["heldObjects"] or []))
        else:
            self._base_position = {
                "x": 0, "y": self.agent_center_y_height, "z": 0, "theta": 0,
            }
            self._wrist_pose = {"y": 0, "z": 0, "yaw": 0}
            self._hand_position = {"x": None, "y": None, "z": 0}
            self._gripper_openness = 0
            self._held_oids: Set[Tuple[bool, str]] = set()

    # ------------------------------------------------------------------
    @property
    def base_position(self) -> dict:
        return self._base_position

    @property
    def wrist_pose(self) -> dict:
        return self._wrist_pose

    @property
    def hand_position(self) -> dict:
        return self._hand_position

    @property
    def gripper_openness(self) -> float:
        return self._gripper_openness

    @property
    def held_oids(self) -> Set[Tuple[bool, str]]:
        return self._held_oids

    # ------------------------------------------------------------------
    @classmethod
    def signed_travel_distance_wrist(cls, initial_angle: float, final_angle: float) -> float:
        """Signed wrist travel honoring the forbidden zone between the wrist
        rotation bounds (reference stretch_state.py:131-159): a final angle
        inside the zone clamps to the nearer bound; travel crossing the zone
        goes the long way around."""
        theta_bound_1, theta_bound_2 = cls.wrist_rotation_bounds
        initial_angle = initial_angle % 360
        final_angle = final_angle % 360
        if theta_bound_1 <= final_angle <= theta_bound_2:
            if abs(final_angle - theta_bound_1) < abs(final_angle - theta_bound_2):
                final_angle = theta_bound_1
            else:
                final_angle = theta_bound_2
        if final_angle > initial_angle:
            if initial_angle < theta_bound_1 and final_angle > theta_bound_2:
                return final_angle - initial_angle - 360
            return final_angle - initial_angle
        if initial_angle > theta_bound_2 and final_angle < theta_bound_1:
            return final_angle - initial_angle + 360
        return final_angle - initial_angle

    @classmethod
    def _create_difference_state(
        cls, diff_base, diff_wrist, diff_hand, diff_gripper, diff_held_oids
    ) -> "StretchState":
        s = cls()
        s._base_position = {**diff_base, "y": 0}
        s._wrist_pose = diff_wrist
        s._hand_position = diff_hand
        s._gripper_openness = diff_gripper
        s._held_oids = diff_held_oids
        return s

    @classmethod
    def _delta_held_oids(cls, after_state, before_state):
        """Additions keep flag True; deletions flip to False
        (reference stretch_state.py:233-238)."""
        additions = after_state.held_oids - before_state.held_oids
        deletions = before_state.held_oids - after_state.held_oids
        return set((False, oid) for _, oid in deletions) | additions

    @staticmethod
    def difference(final_state: "StretchState", initial_state: "StretchState") -> "StretchState":
        """SIGNED difference state (reference stretch_state.py:162-230):
        base x/z displacement expressed in the INITIAL agent frame, theta
        wrapped to +-180, wrist yaw via the forbidden-zone travel distance."""
        base_in_initial_frame = convert_world_to_agent_coordinate(
            final_state.base_position,
            {
                "x": initial_state.base_position["x"],
                "y": initial_state.agent_center_y_height,
                "z": initial_state.base_position["z"],
            },
            initial_state.base_position["theta"],
        )
        diff_base = {}
        for key in ("x", "z", "theta"):
            if (
                final_state.base_position[key] is None
                or initial_state.base_position[key] is None
            ):
                diff_base[key] = 0
            elif key == "theta":
                diff_base[key] = wrap_angle_to_pm180(
                    final_state.base_position[key] - initial_state.base_position[key]
                )
            else:
                diff_base[key] = base_in_initial_frame[key]

        diff_wrist = {}
        for key in ("y", "z", "yaw"):
            if (
                final_state.wrist_pose[key] is None
                or initial_state.wrist_pose[key] is None
            ):
                diff_wrist[key] = 0
            elif key == "yaw":
                diff_wrist[key] = StretchState.signed_travel_distance_wrist(
                    initial_state.wrist_pose[key], final_state.wrist_pose[key]
                )
            else:
                diff_wrist[key] = (
                    final_state.wrist_pose[key] - initial_state.wrist_pose[key]
                )

        diff_hand = {}
        for key in final_state.hand_position.keys():
            if (
                final_state.hand_position[key] is None
                or initial_state.hand_position[key] is None
            ):
                diff_hand[key] = 0
            else:
                diff_hand[key] = (
                    final_state.hand_position[key] - initial_state.hand_position[key]
                )

        diff_gripper = (
            0
            if final_state.gripper_openness is None
            or initial_state.gripper_openness is None
            else final_state.gripper_openness - initial_state.gripper_openness
        )

        return StretchState._create_difference_state(
            diff_base,
            diff_wrist,
            diff_hand,
            diff_gripper,
            StretchState._delta_held_oids(final_state, initial_state),
        )

    @staticmethod
    def state_change_within_tolerance(
        delta_state: "StretchState", tolerance: "StretchState"
    ) -> Tuple[bool, Dict[str, Any]]:
        """(all_within, exceeding params): True means the change is within
        tolerance in every field (i.e. effectively no motion). Base x/z
        compare as a root-sum-square against the RSS of the tolerances
        (reference stretch_state.py:306-378)."""
        exceeding: Dict[str, Any] = {
            "base_position": [],
            "wrist_pose": [],
            "hand_position": [],
            "gripper_openness": [],
            "held_oids": [],
        }
        base_ok = True
        rss = math.sqrt(
            delta_state.base_position["x"] ** 2 + delta_state.base_position["z"] ** 2
        )
        threshold = math.sqrt(
            tolerance.base_position["x"] ** 2 + tolerance.base_position["z"] ** 2
        )
        if rss > threshold:
            exceeding["base_position"].extend(["x", "z"])
            base_ok = False
        if abs(delta_state.base_position["theta"]) > tolerance.base_position["theta"]:
            exceeding["base_position"].append("theta")
            base_ok = False

        wrist_ok = True
        for k in delta_state.wrist_pose.keys():
            if abs(delta_state.wrist_pose[k]) > tolerance.wrist_pose[k]:
                exceeding["wrist_pose"].append(k)
                wrist_ok = False

        hand_ok = True
        for k in delta_state.hand_position.keys():
            if abs(delta_state.hand_position[k] or 0) > tolerance.hand_position[k]:
                exceeding["hand_position"].append(k)
                hand_ok = False

        gripper_ok = abs(delta_state.gripper_openness) <= tolerance.gripper_openness
        if not gripper_ok:
            exceeding["gripper_openness"].append("gripper_openness")

        held_ok = True
        if len(delta_state.held_oids) > 0:
            exceeding["held_oids"].extend(list(delta_state.held_oids))
            held_ok = False

        return (
            base_ok and wrist_ok and hand_ok and gripper_ok and held_ok,
            exceeding,
        )
