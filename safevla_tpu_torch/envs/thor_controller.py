"""AI2-THOR Stretch robot controller facade (real-simulator binding).

Copy of `safevla_tpu/envs/thor_controller.py`. `ai2thor` is imported only
where the controller is built (`StretchController.__init__`) and where its
arguments are (`default_thor_env_args`), so the module imports without it.
Counterpart of reference environment/stretch_controller.py:53-1282 on the
controller surface the framework consumes (see envs/controller_base.py).
Requires the `ai2thor` optional dependency and the pinned Unity build; all
other framework layers run without it via FakeController.

Key semantics reproduced:
  * camera crops 396 -> 384 width (reference l.167-178)
  * discrete action execution with magnitudes and wrist bounds (l.782-890)
  * action-success heuristics via StretchState tolerance diffs (l.770-780,
    890-908): arm/wrist actions succeed only if the state actually changed
  * scene reset with per-radius navmesh injection + calibration randomization
    (l.334-425)
  * visibility caches reset per step (l.294-296)
"""

from __future__ import annotations

import math
import random
from typing import Any, Dict, List, Literal, Optional, Tuple

import numpy as np

from safevla_tpu_torch.constants import (
    ADDITIONAL_ARM_ARGS,
    ADDITIONAL_NAVIGATION_ARGS,
    AGENT_MOVEMENT_CONSTANT,
    AGENT_ROTATION_DEG,
    ARM_MOVE_CONSTANT,
    HORIZON,
    INTEL_CAMERA_HEIGHT,
    INTEL_CAMERA_WIDTH,
    INTEL_VERTICAL_FOV,
    MAXIMUM_SERVER_TIMEOUT,
    STRETCH_COMMIT_ID,
    STRETCH_WRIST_BOUND_1,
    STRETCH_WRIST_BOUND_2,
    WRIST_ROTATION,
)
from safevla_tpu_torch.envs.controller_base import BaseController
from safevla_tpu_torch.envs.geometry import (
    get_room_id_from_location,
    get_rooms_polymap_and_type,
)
from safevla_tpu_torch.envs.stretch_state import StretchState
from safevla_tpu_torch.types import THORActions

AGENT_RADIUS_LIST = [(0, 0.5), (1, 0.4), (2, 0.3), (3, 0.2)]


def default_thor_env_args(**overrides) -> Dict[str, Any]:
    """STRETCH_ENV_ARGS equivalent (reference stretch_initialization_utils.py:94-119)."""
    import ai2thor.fifo_server

    args = dict(
        gridSize=AGENT_MOVEMENT_CONSTANT * 0.75,
        width=INTEL_CAMERA_WIDTH,
        height=INTEL_CAMERA_HEIGHT,
        visibilityDistance=0.8673349051766235,
        visibilityScheme="Distance",
        fieldOfView=INTEL_VERTICAL_FOV,
        server_class=ai2thor.fifo_server.FifoServer,
        useMassThreshold=False,
        massThreshold=1,
        autoSimulation=False,
        autoSyncTransforms=True,
        renderInstanceSegmentation=True,
        agentMode="stretch",
        renderDepthImage=False,
        cameraNearPlane=0.01,
        branch=None,
        commit_id=STRETCH_COMMIT_ID,
        server_timeout=MAXIMUM_SERVER_TIMEOUT,
        snapToGrid=False,
        fastActionEmit=True,
        render_mani_camera=True,
        use_quick_navi_action=True,
    )
    args.update(overrides)
    return args


class StretchController(BaseController):
    def __init__(
        self,
        initialize_controller: bool = True,
        render_mani_camera: bool = True,
        use_quick_navi_action: bool = False,
        **kwargs: Any,
    ):
        from ai2thor.controller import Controller

        self.render_mani_camera = render_mani_camera
        self.use_quick_navi_action = use_quick_navi_action
        self.should_render_image_synthesis = bool(
            kwargs.get("renderDepthImage")
            or kwargs.get("renderNormalsImage")
            or kwargs.get("renderFlowImage")
        )
        self.room_poly_map = {}
        self.room_type_dict = {}
        self.current_scene_json: Optional[Dict] = None
        self._nav_visible_objects_cache: Dict[float, List[str]] = {}
        self._manip_visible_objects_cache: Dict[float, List[str]] = {}

        if initialize_controller:
            self.controller = Controller(**kwargs)
            self.initialization_args = kwargs
            if "scene" in kwargs:
                self.reset(kwargs["scene"])
            if self.render_mani_camera:
                if not self._manip_fov_correct():
                    self.controller.step(
                        "UpdateThirdPartyCamera",
                        thirdPartyCameraId=0,
                        fieldOfView=INTEL_VERTICAL_FOV,
                    )
            else:
                self.controller.step("DisableSecondaryCamera")
                self.controller.step("Pass")
        else:
            self.controller = None

        # minimum state change for a spatial action to count as "moved"
        self._universal_state_tolerance = StretchState._create_difference_state(
            diff_base={"x": 0.01, "z": 0.01, "theta": 1.5},
            diff_wrist={"y": 0.005, "z": 0.005, "yaw": 2},
            diff_hand={"x": 100, "y": 100, "z": 100},
            diff_gripper=100,
            diff_held_oids=set(),
        )

    def _manip_fov_correct(self) -> bool:
        cams = self.controller.last_event.metadata.get("thirdPartyCameras", [])
        return bool(cams) and abs(cams[0]["fieldOfView"] - INTEL_VERTICAL_FOV) < 2

    # ------------------------------------------------------------------
    # lifecycle
    # ------------------------------------------------------------------
    def stop(self):
        if self.controller is not None:
            self.controller.stop()

    def step(self, action: Optional[str] = None, **kwargs):
        if action is not None:
            kwargs["action"] = action
        if "renderImageSynthesis" not in kwargs:
            kwargs["renderImageSynthesis"] = self.should_render_image_synthesis
        if kwargs["action"] in ("Teleport", "TeleportFull"):
            raise NotImplementedError("Use teleport_agent, not a raw Teleport step.")
        if kwargs["action"] == "__Teleport__":
            kwargs["action"] = "Teleport"
        return self.controller.step(**kwargs)

    def reset(self, scene: Dict[str, Any], seed: Optional[int] = None):
        if scene is None:
            raise ValueError("`scene` must be non-None.")
        self.current_scene_json = scene
        base_navmesh = {
            "agentHeight": 1.8,
            "agentSlope": 10,
            "agentClimb": 0.5,
            "voxelSize": 0.1666667,
        }
        scene["metadata"]["navMeshes"] = [
            {**base_navmesh, "id": i, "agentRadius": r} for (i, r) in AGENT_RADIUS_LIST
        ]
        if "agent" not in scene["metadata"]:
            scene["metadata"]["agent"] = {
                "horizon": 30,
                "position": {"x": 0, "y": 0.95, "z": 0},
                "rotation": {"x": 0, "y": 270, "z": 0},
                "standing": True,
            }
        scene["metadata"]["agent"]["horizon"] = HORIZON

        self.reset_visibility_cache()
        reset_event = self.controller.reset(scene=scene)
        if seed is not None:
            self.controller.step("SetRandomSeed", seed=seed)
        self.calibrate_agent()
        self.controller.step("ToggleMagnetVisibility", visible=False, raise_for_failure=True)
        self.set_object_filter([])
        self.room_poly_map, self.room_type_dict = get_rooms_polymap_and_type(scene)
        if not self.render_mani_camera:
            self.controller.step("DisableSecondaryCamera")
            self.controller.step("Pass")
        return reset_event

    def calibrate_agent(self):
        """Camera-mount and FOV randomization (reference l.334-370)."""
        self.step(
            action="RotateCameraMount",
            degrees=27.0 + random.choice(np.arange(-2, 2, 0.2)),
            secondary=False,
            raise_for_failure=True,
            renderImage=False,
        )
        self.step(
            action="RotateCameraMount",
            degrees=33.0 + random.choice(np.arange(-2, 2, 0.2)),
            secondary=True,
            raise_for_failure=True,
        )
        for camera in ("FirstPersonCharacter", "SecondaryCamera"):
            self.step(
                action="ChangeFOV",
                fieldOfView=59 + random.choice(np.arange(-1, 1, 0.1)),
                camera=camera,
                raise_for_failure=True,
                renderImage=False,
            )
        self.step(action="SetGripperOpenness", openness=30, raise_for_failure=True)

    def set_object_filter(self, object_ids: List[str]):
        self.controller.step("SetObjectFilter", objectIds=object_ids, renderImage=False)

    def teleport_agent(self, position, rotation, horizon=0, standing=True, **kwargs):
        if isinstance(rotation, dict):
            rotation = rotation["y"]
        return self.step(
            action="__Teleport__",
            position=position,
            rotation=dict(x=0, y=rotation, z=0),
            **{k: v for k, v in kwargs.items() if k in ("forceAction", "renderImage")},
        )

    # ------------------------------------------------------------------
    # cameras (396 -> 384 width crops)
    # ------------------------------------------------------------------
    @property
    def navigation_camera(self) -> np.ndarray:
        frame = self.controller.last_event.frame
        cutoff = round(frame.shape[1] * 6 / 396)
        return frame[:, cutoff:-cutoff, :]

    @property
    def manipulation_camera(self) -> np.ndarray:
        if self.render_mani_camera:
            frame = self.controller.last_event.third_party_camera_frames[0]
            cutoff = round(frame.shape[1] * 6 / 396)
            return frame[:, cutoff:-cutoff, :3]
        return self.navigation_camera

    # ------------------------------------------------------------------
    # agent / arm state
    # ------------------------------------------------------------------
    def get_current_agent_position(self) -> Dict[str, float]:
        return dict(self.controller.last_event.metadata["agent"]["position"])

    def get_current_agent_full_pose(self) -> Dict[str, Any]:
        agent = self.controller.last_event.metadata["agent"]
        return {
            "position": dict(agent["position"]),
            "rotation": dict(agent["rotation"]),
            "horizon": agent["cameraHorizon"],
            "isStanding": agent.get("isStanding", True),
        }

    def get_relative_stretch_current_arm_state(self) -> Dict[str, float]:
        joints = self.controller.last_event.metadata["arm"]["joints"]
        z = joints[-1]["rootRelativePosition"]["z"]
        x = joints[-1]["rootRelativePosition"]["x"]
        y = joints[0]["rootRelativePosition"]["y"] - 0.16297650337219238
        return dict(x=x, y=y, z=z)

    def get_arm_wrist_rotation(self) -> float:
        joint = self.controller.last_event.metadata["arm"]["joints"][-1]
        return math.fmod(
            joint["rootRelativeRotation"]["w"] * joint["rootRelativeRotation"]["y"], 360
        )

    def get_arm_proprioception(self) -> List[float]:
        joint = self.controller.last_event.metadata["arm"]["joints"][-1]
        pos = [joint["rootRelativePosition"][k] for k in ("x", "y", "z")]
        return pos + [self.get_arm_wrist_rotation()]

    def get_arm_sphere_center(self):
        return self.controller.last_event.metadata["arm"]["handSphereCenter"]

    # ------------------------------------------------------------------
    # objects
    # ------------------------------------------------------------------
    def get_objects(self) -> List[Dict[str, Any]]:
        return self.controller.last_event.metadata["objects"]

    def get_obj_pos_from_obj_id(self, object_id: str) -> Dict[str, float]:
        for o in self.get_objects():
            if o["objectId"] == object_id:
                return dict(o["position"])
        raise KeyError(object_id)

    def get_held_objects(self) -> List[str]:
        return self.controller.last_event.metadata["arm"]["heldObjects"]

    def get_objects_in_hand_sphere(self) -> List[str]:
        return self.controller.last_event.metadata["arm"]["pickupableObjects"]

    def get_all_objects_of_synset(
        self, synset: str, include_hyponyms: bool = True
    ) -> List[Dict[str, Any]]:
        stem = synset.split(".")[0].lower().replace("_", "")
        return [
            o
            for o in self.get_objects()
            if stem in o["objectType"].lower().replace("_", "")
        ]

    # ------------------------------------------------------------------
    # visibility
    # ------------------------------------------------------------------
    def reset_visibility_cache(self):
        self._nav_visible_objects_cache = {}
        self._manip_visible_objects_cache = {}

    def get_visible_objects(
        self,
        which_camera: Literal["nav", "manip", "both"] = "nav",
        maximum_distance: float = 2,
    ) -> List[str]:
        if isinstance(which_camera, (int, float)):
            # tolerate positional maximum_distance usage
            maximum_distance, which_camera = which_camera, "nav"
        out: List[str] = []
        if which_camera in ("nav", "both"):
            if maximum_distance not in self._nav_visible_objects_cache:
                ev = self.controller.step(
                    "GetVisibleObjects",
                    maxDistance=maximum_distance,
                    renderImage=False,
                )
                self._nav_visible_objects_cache[maximum_distance] = list(
                    ev.metadata["actionReturn"] or []
                )
            out += self._nav_visible_objects_cache[maximum_distance]
        if which_camera in ("manip", "both"):
            if maximum_distance not in self._manip_visible_objects_cache:
                ev = self.controller.step(
                    "GetVisibleObjects",
                    maxDistance=maximum_distance,
                    thirdPartyCameraIndex=0,
                    renderImage=False,
                )
                self._manip_visible_objects_cache[maximum_distance] = list(
                    ev.metadata["actionReturn"] or []
                )
            out += self._manip_visible_objects_cache[maximum_distance]
        return out

    def object_is_visible_in_camera(
        self, object_id: str, which_camera: str = "nav", maximum_distance: float = 2
    ) -> bool:
        return object_id in self.get_visible_objects(
            which_camera=which_camera, maximum_distance=maximum_distance
        )

    # ------------------------------------------------------------------
    # spatial queries
    # ------------------------------------------------------------------
    def get_reachable_positions(self) -> List[Dict[str, float]]:
        ev = self.controller.step(action="GetReachablePositions")
        return list(ev.metadata["actionReturn"] or [])

    def get_shortest_path_to_object(self, object_id, initial_position=None):
        kwargs = {"objectId": object_id, "allowedError": 0.05}
        if initial_position is not None:
            kwargs["position"] = initial_position
        ev = self.controller.step(action="GetShortestPath", **kwargs)
        if not ev:
            return None
        return ev.metadata["actionReturn"]["corners"]

    def get_closest_object_from_ids(
        self, object_ids: List[str], return_id_and_dist: bool = True
    ) -> Tuple[Optional[str], float]:
        """Geodesic closest object via navmesh paths, agent-position fallback."""
        agent = self.get_current_agent_position()
        best, best_d = None, float("inf")
        for oid in object_ids:
            corners = self.get_shortest_path_to_object(oid)
            if corners:
                d = 0.0
                for a, b in zip(corners[:-1], corners[1:]):
                    d += math.hypot(a["x"] - b["x"], a["z"] - b["z"])
            else:
                try:
                    pos = self.get_obj_pos_from_obj_id(oid)
                except KeyError:
                    continue
                d = math.hypot(pos["x"] - agent["x"], pos["z"] - agent["z"])
            if d < best_d:
                best, best_d = oid, d
        if best is None:
            return None, -1.0
        return best, best_d

    def dist_from_arm_sphere_center_to_obj(self, object_id: str) -> float:
        center = self.get_arm_sphere_center()
        pos = self.get_obj_pos_from_obj_id(object_id)
        return math.sqrt(
            (center["x"] - pos["x"]) ** 2
            + (center["y"] - pos["y"]) ** 2
            + (center["z"] - pos["z"]) ** 2
        )

    def dist_from_arm_sphere_center_to_obj_colliders_closest_to_point(
        self, object_id: str
    ) -> float:
        center = self.get_arm_sphere_center()
        for o in self.get_objects():
            if o["objectId"] == object_id and o.get("axisAlignedBoundingBox"):
                box = o["axisAlignedBoundingBox"]
                c, s = box["center"], box["size"]
                dx = max(abs(center["x"] - c["x"]) - s["x"] / 2, 0)
                dy = max(abs(center["y"] - c["y"]) - s["y"] / 2, 0)
                dz = max(abs(center["z"] - c["z"]) - s["z"] / 2, 0)
                return math.sqrt(dx * dx + dy * dy + dz * dz)
        return self.dist_from_arm_sphere_center_to_obj(object_id)

    def get_room_id_from_location(self, position):
        return get_room_id_from_location(self.room_poly_map, position)


    def get_agent_alignment_to_object(self, object_id, use_arm_orientation=False):
        """Signed yaw (deg) from heading (or arm axis, +90) to the object
        (reference stretch_controller.py:730-739)."""
        from safevla_tpu_torch.envs.geometry import heading_to_target

        pose = self.get_current_agent_full_pose()
        if use_arm_orientation:
            pose = {
                "position": pose["position"],
                "rotation": {**pose["rotation"], "y": pose["rotation"]["y"] + 90},
            }
        return heading_to_target(pose, self.get_obj_pos_from_obj_id(object_id))

    def get_objects_room_id_and_type(self, object_id):
        """Room id + type containing the object
        (reference stretch_controller.py object->room query used by the eval
        worker's has_agent_been_in_obj_room, online_evaluator_worker.py:418-435)."""
        pos = self.get_obj_pos_from_obj_id(object_id)
        room_id = self.get_room_id_from_location(pos)
        return room_id, self.room_type_dict.get(room_id, "Unknown")

    def get_top_down_path_view(self, agent_path, targets_to_highlight=None):
        """Render the followed path from an overhead camera
        (reference stretch_controller.py:300-332)."""
        if len(self.controller.last_event.third_party_camera_frames) < 2:
            ev = self.controller.step({"action": "GetMapViewCameraProperties"})
            cam = ev.metadata["actionReturn"].copy()
            bounds = ev.metadata["sceneBounds"]["size"]
            max_bound = max(bounds["x"], bounds["z"])
            cam["fieldOfView"] = 50
            cam["position"]["y"] += 1.1 * max_bound
            cam["orthographic"] = False
            cam["farClippingPlane"] = 50
            cam.pop("orthographicSize", None)
            self.controller.step(
                {"action": "AddThirdPartyCamera", "skyboxColor": "white", **cam}
            )
        self.controller.step({"action": "VisualizeWaypoints", "waypoints": []})
        ev = self.controller.step(
            {"action": "VisualizePath", "positions": agent_path, "pathWidth": 0.2}
        )
        self.controller.step({"action": "HideVisualizedPath"})
        frame = ev.third_party_camera_frames[-1]
        cutoff = round(frame.shape[1] * 6 / 396)
        return frame[:, cutoff:-cutoff, :], agent_path

    # ------------------------------------------------------------------
    # action execution
    # ------------------------------------------------------------------
    def sufficient_agent_state_change(self, before: StretchState, after: StretchState):
        too_small, _ = StretchState.state_change_within_tolerance(
            delta_state=StretchState.difference(after, before),
            tolerance=self._universal_state_tolerance,
        )
        return not too_small

    def agent_step(self, action: str):
        before = StretchState(self.controller)

        if action == THORActions.move_ahead:
            action_dict = (
                dict(action="MoveAheadQuick", moveMagnitude=AGENT_MOVEMENT_CONSTANT)
                if self.use_quick_navi_action
                else dict(action="MoveAgent", ahead=AGENT_MOVEMENT_CONSTANT)
            )
        elif action == THORActions.move_back:
            action_dict = (
                dict(action="MoveBackQuick", moveMagnitude=AGENT_MOVEMENT_CONSTANT)
                if self.use_quick_navi_action
                else dict(action="MoveAgent", ahead=-AGENT_MOVEMENT_CONSTANT)
            )
        elif action in THORActions.ROTATE_ACTIONS:
            degree = {
                THORActions.rotate_right: AGENT_ROTATION_DEG,
                THORActions.rotate_left: -AGENT_ROTATION_DEG,
                THORActions.rotate_right_small: AGENT_ROTATION_DEG / 5,
                THORActions.rotate_left_small: -AGENT_ROTATION_DEG / 5,
            }[action]
            action_dict = (
                dict(action="RotateRightQuick", degrees=degree)
                if self.use_quick_navi_action
                else dict(action="RotateAgent", degrees=degree)
            )
        elif action in THORActions.ARM_ACTIONS:
            base = self.get_relative_stretch_current_arm_state()
            delta = ARM_MOVE_CONSTANT / (5 if action.endswith("s") else 1)
            axis = "y" if action.startswith("y") else "z"
            sign = -1 if action[1] == "m" else 1
            base[axis] += sign * delta
            action_dict = dict(
                action="MoveArm",
                position=dict(x=base["x"], y=base["y"], z=base["z"]),
            )
        elif action in (THORActions.wrist_open, THORActions.wrist_close):
            curr = self.get_arm_wrist_rotation()
            if action == THORActions.wrist_open:
                yaw = -1 * min(WRIST_ROTATION, abs(curr - (STRETCH_WRIST_BOUND_2 + 360)))
            else:
                yaw = min(WRIST_ROTATION, abs(STRETCH_WRIST_BOUND_1 - curr))
            action_dict = dict(action="RotateWristRelative", yaw=yaw)
        elif action == THORActions.pickup:
            action_dict = dict(action="PickupObject")
        elif action == THORActions.dropoff:
            action_dict = dict(action="ReleaseObject")
        else:
            raise NotImplementedError(f"Action not defined: {action}")

        if action_dict["action"] in ("RotateWristRelative", "MoveArm"):
            action_dict = {**action_dict, **ADDITIONAL_ARM_ARGS}
        elif action_dict["action"] == "MoveAgent":
            action_dict = {**action_dict, **ADDITIONAL_NAVIGATION_ARGS}

        event = self.step(**action_dict)
        if action == THORActions.dropoff:
            self.step(action="AdvancePhysicsStep", simSeconds=2)

        after = StretchState(self.controller)
        moved = self.sufficient_agent_state_change(before, after)
        collided = "collided" in event.metadata["errorMessage"].lower()

        if action == THORActions.pickup:
            # success is judged by the task (did the hand grab the target?)
            action_success = False
        elif action == THORActions.dropoff:
            action_success = True
        elif "arm" in action_dict["action"].lower() or "wrist" in action_dict["action"].lower():
            action_success = not collided and moved
        else:
            action_success = not collided

        event.metadata["lastActionSuccess"] = action_success
        return event
