"""A deterministic, simulator-free controller for tests and benchmarks.

Implements the full `BaseController` surface over a synthetic house: a 2D
grid of reachable positions inside rectangular rooms, seeded random objects,
a simple motion model with wall collisions, and procedurally-generated camera
images. The SURVEY test plan calls this out as the key enabler for testing
task/sampler/rollout logic without Unity (SURVEY §4b); it also serves as an
infinitely-fast environment to measure the framework's own overhead.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from safevla_tpu_torch.constants import (
    AGENT_MOVEMENT_CONSTANT,
    AGENT_ROTATION_DEG,
    INTEL_CAMERA_HEIGHT,
    INTEL_CAMERA_WIDTH,
)
from safevla_tpu_torch.envs.controller_base import BaseController, Event
from safevla_tpu_torch.types import THORActions
from safevla_tpu_torch.utils.metrics import position_dist

_OBJECT_TYPES = [
    "Mug", "Apple", "Laptop", "Vase", "Knife", "Book", "Plate", "Bottle",
    "Cup", "Bowl", "Candle", "Statue", "Pot", "Pan", "Chair",
]


class FakeController(BaseController):
    """Synthetic house: [0, size] x [0, size] floor split into 2 rooms."""

    def __init__(
        self,
        seed: int = 0,
        size: float = 6.0,
        num_objects: int = 20,
        image_height: int = INTEL_CAMERA_HEIGHT,
        image_width: int = INTEL_CAMERA_WIDTH - (INTEL_CAMERA_WIDTH % 32),
        **kwargs: Any,
    ):
        self._seed = seed
        self.size = size
        self.num_objects = num_objects
        self.image_hw = (image_height, image_width)
        self._rng = np.random.default_rng(seed)
        self._scene_counter = 0
        self._held_objects: List[str] = []
        self.room_poly_map: Dict[str, Tuple[float, float, float, float]] = {}
        self.room_type_dict: Dict[str, str] = {}
        self._frame_cache: Dict[str, np.ndarray] = {}
        self.reset(scene={"rooms": [{}, {}]})

    # ------------------------------------------------------------------
    def reset(self, scene: Dict[str, Any], seed: Optional[int] = None) -> Event:
        # object layout is a deterministic function of the controller seed so
        # task specs built against a house stay valid across scene resets
        self._rng = np.random.default_rng(self._seed if seed is None else seed)
        self._scene_counter += 1
        s = self.size
        self.room_poly_map = {
            "room0": (0.0, 0.0, s / 2, s),
            "room1": (s / 2, 0.0, s, s),
        }
        self.room_type_dict = {"room0": "LivingRoom", "room1": "Kitchen"}
        self.agent = {
            "position": {"x": s / 4, "y": 0.9, "z": s / 2},
            "rotation": {"x": 0.0, "y": 0.0, "z": 0.0},
            "horizon": 0,
            "isStanding": True,
        }
        self.arm = {"y": 0.8, "z": 0.0, "wrist": 0.0, "gripper_open": 50.0}
        self._held_objects = []
        self._objects = self._spawn_objects()
        self._frame_cache.clear()
        self._last_error = ""
        self._last_collided = False
        return Event(True)

    def _spawn_objects(self) -> List[Dict[str, Any]]:
        objs = []
        for i in range(self.num_objects):
            otype = _OBJECT_TYPES[int(self._rng.integers(len(_OBJECT_TYPES)))]
            pos = {
                "x": float(self._rng.uniform(0.2, self.size - 0.2)),
                "y": float(self._rng.uniform(0.1, 1.5)),
                "z": float(self._rng.uniform(0.2, self.size - 0.2)),
            }
            objs.append(
                {
                    "objectId": f"{otype}|{i}",
                    "name": f"{otype}_{i}",
                    "objectType": otype,
                    "position": pos,
                    "rotation": {"x": 0.0, "y": float(self._rng.uniform(0, 360)), "z": 0.0},
                    "visible": False,
                    "distance": 0.0,
                    "pickupable": otype not in ("Chair",),
                }
            )
        return objs

    # ------------------------------------------------------------------
    def stop(self) -> None:
        pass

    def calibrate_agent(self) -> None:
        pass

    def _refresh_object_metadata(self):
        apos = self.agent["position"]
        ayaw = math.radians(self.agent["rotation"]["y"])
        fx, fz = math.sin(ayaw), math.cos(ayaw)
        # one vectorized pass (runs every sim step over all objects)
        pos = np.array(
            [
                (o["position"]["x"], o["position"]["y"], o["position"]["z"])
                for o in self._objects
            ]
        )
        d = np.sqrt(
            (pos[:, 0] - apos["x"]) ** 2
            + (pos[:, 1] - apos["y"]) ** 2
            + (pos[:, 2] - apos["z"]) ** 2
        )
        dx = pos[:, 0] - apos["x"]
        dz = pos[:, 2] - apos["z"]
        # visible if within 4m and inside a ~90deg forward cone
        dot = dx * fx + dz * fz
        vis = (d < 4.0) & (dot > 0.5 * np.maximum(d, 1e-6))
        for o, di, vi in zip(self._objects, d, vis):
            o["distance"] = float(di)
            o["visible"] = bool(vi)

    def agent_step(self, action: str) -> Event:
        self._last_error = ""
        self._last_collided = False
        pos = self.agent["position"]
        yaw = self.agent["rotation"]["y"]

        if action in (THORActions.move_ahead, THORActions.move_back):
            sign = 1.0 if action == THORActions.move_ahead else -1.0
            rad = math.radians(yaw)
            nx = pos["x"] + sign * AGENT_MOVEMENT_CONSTANT * math.sin(rad)
            nz = pos["z"] + sign * AGENT_MOVEMENT_CONSTANT * math.cos(rad)
            if 0.1 <= nx <= self.size - 0.1 and 0.1 <= nz <= self.size - 0.1:
                hit = self._object_collision(nx, nz)
                if hit is None:
                    pos["x"], pos["z"] = nx, nz
                    success = True
                else:
                    self._last_error = f"agent collided with '{hit.lower()}' during move"
                    self._last_collided = True
                    success = False
            else:
                self._last_error = "agent collided with 'wall' during move"
                self._last_collided = True
                success = False
        elif action in (
            THORActions.rotate_left,
            THORActions.rotate_right,
            THORActions.rotate_left_small,
            THORActions.rotate_right_small,
        ):
            delta = AGENT_ROTATION_DEG
            if action in (THORActions.rotate_left, THORActions.rotate_left_small):
                delta = -delta
            if action in (THORActions.rotate_left_small, THORActions.rotate_right_small):
                delta /= 5
            self.agent["rotation"]["y"] = (yaw + delta) % 360
            success = True
        elif action in THORActions.ARM_ACTIONS:
            axis = "y" if action.startswith("y") else "z"
            delta = 0.1 / (5 if action.endswith("s") else 1)
            if "m" in action[1:2]:
                delta = -delta
            self.arm[axis] = float(np.clip(self.arm[axis] + delta, 0.0, 1.1))
            success = True
        elif action in (THORActions.wrist_open, THORActions.wrist_close):
            self.arm["wrist"] += -10 if action == THORActions.wrist_open else 10
            success = True
        elif action == THORActions.pickup:
            in_sphere = self.get_objects_in_hand_sphere()
            if in_sphere and not self._held_objects:
                self._held_objects = [in_sphere[0]]
                success = True
            else:
                success = False
                self._last_error = "nothing to pick up"
        elif action == THORActions.dropoff:
            success = bool(self._held_objects)
            self._held_objects = []
        else:
            success = True

        # tiny seeded object jitter so disturbance detectors see motion
        if self._rng.random() < 0.05:
            j = int(self._rng.integers(len(self._objects)))
            self._objects[j]["position"]["x"] += float(self._rng.normal(0, 0.03))
            if self._objects[j]["objectType"] == "Chair":
                self._collider_cache = None  # collider moved
        self._refresh_object_metadata()
        self._frame_cache.clear()
        return Event(
            success,
            {"errorMessage": self._last_error, "collided": self._last_collided},
        )

    def _collider_arrays(self):
        # chairs never move in this fake scene; cache their positions as
        # arrays (collision checks run many times per step and for every
        # reachable-positions grid point)
        cache = getattr(self, "_collider_cache", None)
        if cache is None:
            chairs = [o for o in self._objects if o["objectType"] == "Chair"]
            cache = (
                np.array([o["position"]["x"] for o in chairs]),
                np.array([o["position"]["z"] for o in chairs]),
                [o["name"] for o in chairs],
            )
            self._collider_cache = cache
        return cache

    def _object_collision(self, nx: float, nz: float) -> Optional[str]:
        cx, cz, names = self._collider_arrays()
        if not len(names):
            return None
        d = (cx - nx) ** 2 + (cz - nz) ** 2
        i = int(np.argmin(d))
        return names[i] if d[i] < 0.04 else None

    def step(self, action: str, **kwargs) -> Event:
        if action == "GetReachablePositions":
            return Event(True, {"actionReturn": self.get_reachable_positions()})
        return Event(True)

    def teleport_agent(
        self, position, rotation, horizon=0, standing=True, forceAction=False
    ) -> Event:
        if not (0 <= position["x"] <= self.size and 0 <= position["z"] <= self.size):
            return Event(False, {"errorMessage": "teleport out of bounds"})
        self.agent["position"] = dict(position)
        self.agent["rotation"] = dict(rotation)
        self._refresh_object_metadata()
        self._frame_cache.clear()
        return Event(True)

    # ------------------------------------------------------------------
    def get_current_agent_position(self) -> Dict[str, float]:
        return dict(self.agent["position"])

    def get_current_agent_full_pose(self) -> Dict[str, Any]:
        return {
            "position": dict(self.agent["position"]),
            "rotation": dict(self.agent["rotation"]),
            "horizon": self.agent["horizon"],
            "isStanding": self.agent["isStanding"],
        }

    def get_arm_proprioception(self) -> List[float]:
        return [self.arm["y"], self.arm["z"], self.arm["wrist"], self.arm["gripper_open"]]

    # ------------------------------------------------------------------
    _FRAME_BANK: Dict[tuple, np.ndarray] = {}

    def _render(self, which: str) -> np.ndarray:
        """Cheap procedural frame: deterministic function of agent pose.

        Frames come from a small pre-generated bank (shared per resolution) so
        rendering is an index, not an RNG fill — the fake env must stay orders
        of magnitude cheaper than the policy to benchmark the compute path.
        """
        if which in self._frame_cache:
            return self._frame_cache[which]
        bank_key = self.image_hw
        bank = FakeController._FRAME_BANK.get(bank_key)
        if bank is None:
            h, w = self.image_hw
            bank = np.random.default_rng(1234).integers(
                0, 255, (16, h, w, 3), dtype=np.uint8
            )
            FakeController._FRAME_BANK[bank_key] = bank
        pos = self.agent["position"]
        yaw = self.agent["rotation"]["y"]
        base = int(pos["x"] * 37 + pos["z"] * 91 + yaw + (7 if which == "manip" else 0))
        frame = bank[base % 16]
        self._frame_cache[which] = frame
        return frame

    @property
    def navigation_camera(self) -> np.ndarray:
        return self._render("nav")

    @property
    def manipulation_camera(self) -> np.ndarray:
        return self._render("manip")

    # ------------------------------------------------------------------
    def get_objects(self) -> List[Dict[str, Any]]:
        # snapshot semantics without deepcopy (hot path: called every step)
        return [
            {**o, "position": dict(o["position"]), "rotation": dict(o["rotation"])}
            for o in self._objects
        ]

    def get_obj_pos_from_obj_id(self, object_id: str) -> Dict[str, float]:
        for o in self._objects:
            if o["objectId"] == object_id:
                return dict(o["position"])
        raise KeyError(object_id)

    def get_held_objects(self) -> List[str]:
        return list(self._held_objects)

    def get_objects_in_hand_sphere(self) -> List[str]:
        apos = self.agent["position"]
        hand = {"x": apos["x"], "y": self.arm["y"], "z": apos["z"] + self.arm["z"]}
        return [
            o["objectId"]
            for o in self._objects
            if o["pickupable"] and position_dist(o["position"], hand) < 0.5
        ]

    def get_all_objects_of_synset(
        self, synset: str, include_hyponyms: bool = True
    ) -> List[Dict[str, Any]]:
        stem = synset.split(".")[0].lower()
        return [o for o in self._objects if o["objectType"].lower() == stem]

    # ------------------------------------------------------------------
    def get_visible_objects(self, maximum_distance: float = 4) -> List[str]:
        return [
            o["name"]
            for o in self._objects
            if o["visible"] and o["distance"] <= maximum_distance
        ]

    def object_is_visible_in_camera(
        self, object_id: str, which_camera: str = "nav", maximum_distance: float = 2
    ) -> bool:
        for o in self._objects:
            if o["objectId"] == object_id:
                return bool(o["visible"] and o["distance"] <= maximum_distance)
        return False

    # ------------------------------------------------------------------
    def get_reachable_positions(self) -> List[Dict[str, float]]:
        grid = np.arange(0.25, self.size, 0.25)
        xs, zs = np.meshgrid(grid, grid, indexing="ij")
        xs, zs = xs.ravel(), zs.ravel()
        cx, cz, names = self._collider_arrays()
        if len(names):
            d2 = (xs[:, None] - cx[None, :]) ** 2 + (zs[:, None] - cz[None, :]) ** 2
            free = d2.min(axis=1) >= 0.04
        else:
            free = np.ones(xs.shape, bool)
        return [
            {"x": float(x), "y": 0.9, "z": float(z)}
            for x, z in zip(xs[free], zs[free])
        ]

    def get_closest_object_from_ids(
        self, object_ids: List[str], return_id_and_dist: bool = True
    ) -> Tuple[Optional[str], float]:
        apos = self.agent["position"]
        best, best_d = None, float("inf")
        for oid in object_ids:
            try:
                d = position_dist(self.get_obj_pos_from_obj_id(oid), apos)
            except KeyError:
                continue
            if d < best_d:
                best, best_d = oid, d
        if best is None:
            return None, -1.0
        return best, best_d

    def dist_from_arm_sphere_center_to_obj(self, object_id: str) -> float:
        apos = self.agent["position"]
        hand = {"x": apos["x"], "y": self.arm["y"], "z": apos["z"] + self.arm["z"]}
        return position_dist(self.get_obj_pos_from_obj_id(object_id), hand)

    def dist_from_arm_sphere_center_to_obj_colliders_closest_to_point(
        self, object_id: str
    ) -> float:
        return self.dist_from_arm_sphere_center_to_obj(object_id)

    def get_top_down_path_view(self, agent_path, targets_to_highlight=None):
        """Synthetic overhead render: white canvas, path rasterized in red.
        Mirrors StretchController.get_top_down_path_view's (frame, path)
        return so evaluator video code is controller-agnostic."""
        size = 256
        frame = np.full((size, size, 3), 255, np.uint8)
        xs = [p["x"] if isinstance(p, dict) else p[0] for p in agent_path]
        zs = [p["z"] if isinstance(p, dict) else p[2] for p in agent_path]
        if xs:
            x0, x1 = min(xs) - 1e-6, max(xs) + 1e-6
            z0, z1 = min(zs) - 1e-6, max(zs) + 1e-6
            span = max(x1 - x0, z1 - z0)
            for x, z in zip(xs, zs):
                px = int((x - x0) / span * (size - 20)) + 10
                pz = int((z - z0) / span * (size - 20)) + 10
                frame[max(pz - 2, 0):pz + 2, max(px - 2, 0):px + 2] = (200, 30, 30)
        return frame, agent_path


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
        pos = self.get_obj_pos_from_obj_id(object_id)
        room_id = self.get_room_id_from_location(pos)
        return room_id, self.room_type_dict.get(room_id, "Unknown")

    def get_room_id_from_location(self, position) -> Optional[str]:
        x = position["x"] if isinstance(position, dict) else position[0]
        z = position["z"] if isinstance(position, dict) else position[2]
        for room_id, (x0, z0, x1, z1) in self.room_poly_map.items():
            if x0 <= x <= x1 and z0 <= z <= z1:
                return room_id
        return None
