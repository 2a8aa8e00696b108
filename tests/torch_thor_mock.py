"""A mock `ai2thor` backend for the AI2-THOR controller of both packages.

`install(modules)` puts an `ai2thor` package into `modules` (`sys.modules`,
or pytest's `monkeypatch.setitem` through `ModuleSetter`) whose
`controller.Controller` is `MockTHOR` and whose `fifo_server.FifoServer` is a
placeholder class. `StretchController` imports both inside its functions, so
either package's controller then drives this mock instead of a Unity build.

`MockTHOR` keeps a small world: the agent's pose, the Stretch arm (lift,
extension, wrist yaw, held objects), the house's objects, and a grid of
reachable positions inside the house's room polygons. It answers every
action that `StretchController`, the task samplers, the ObjectNav task, its
cost detectors and the default sensors send, and raises on any other, so a
new action shows up as a failure here instead of a silent success. Camera
frames are uint8 images of the size the controller was built with (`height`
x `width`, 224 x 396 by default, as `default_thor_env_args` asks), drawn from
a numpy generator seeded by the mock's seed and the agent's pose, so the same
pose renders the same frame. `calls` logs every step and reset.

`make_house` and `objectnav_rows` write a house in the format
`LazyJsonHouses` reads and benchmark rows over its objects; `text_tokenizer`
stands in for the T5 tokenizer's files (the hash tokenizer's ids), which the
benchmark protocol requires and which are on no test machine.

This file imports neither package: the CPU tests import it, and
`chip_smoke.py` loads it by its path.
"""

from __future__ import annotations

import copy
import hashlib
import math
import types
from typing import Any, Dict, List, Optional

import numpy as np

GRID = 0.25
ARM_BASE = 0.16297650337219238  # lift joint offset StretchController subtracts
LIFT_RANGE = (0.0, 1.1)
EXTEND_RANGE = (0.0, 0.52)
OBJECT_RADIUS = 0.3  # the agent collides within this distance of an object
AGENT_POSE0 = {"position": {"x": 1.0, "y": 0.9, "z": 1.0}, "rotation": {"x": 0.0, "y": 90.0, "z": 0.0}}


def _floor(points):
    return [{"x": float(x), "y": 0.0, "z": float(z)} for x, z in points]


def make_house(seed: int = 0, n_objects: int = 8) -> Dict[str, Any]:
    """A two-room house (a 4 x 4 m kitchen beside a 4 x 4 m living room)
    with `n_objects` seeded objects, one of them a dangerous knife."""
    rng = np.random.default_rng(seed)
    types_ = ["Mug", "Apple", "Bed", "Laptop", "Vase", "Chair", "Knife", "Plate"]
    objects = []
    for i in range(n_objects):
        t = types_[i % len(types_)]
        x, z = rng.uniform(0.6, 7.4), rng.uniform(0.6, 3.4)
        objects.append({
            "id": f"{t}|{i}",
            "assetId": f"{t}_{i}",
            "objectType": t,
            "position": {"x": float(x), "y": 0.8, "z": float(z)},
            "rotation": {"x": 0.0, "y": float(rng.uniform(0, 360)), "z": 0.0},
            "pickupable": t in ("Mug", "Apple", "Laptop", "Vase", "Knife", "Plate"),
        })
    return {
        "id": f"mock_house_{seed}",
        "rooms": [
            {"id": "room|0", "roomType": "Kitchen", "floorPolygon": _floor([(0, 0), (4, 0), (4, 4), (0, 4)])},
            {"id": "room|1", "roomType": "LivingRoom", "floorPolygon": _floor([(4, 0), (8, 0), (8, 4), (4, 4)])},
        ],
        "objects": objects,
        "metadata": {"agent": copy.deepcopy({**AGENT_POSE0, "horizon": 30, "standing": True})},
    }


def objectnav_rows(house: Dict[str, Any], house_index: int, n: int) -> List[Dict[str, Any]]:
    """ObjectNavType benchmark rows over the house's object types."""
    rows = []
    objs = house["objects"]
    for i in range(n):
        t = objs[i % len(objs)]["objectType"]
        synset = t.lower() + ".n.01"
        ids = [o["id"] for o in objs if o["objectType"] == t]
        rows.append({
            "task_type": "ObjectNavType", "house_index": house_index,
            "natural_language_spec": f"find a {t.lower()}",
            "agent_starting_position": [1.0 + 0.25 * i, 0.9, 1.0 + 0.5 * (i % 3)],
            "agent_y_rotation": float(90 * i % 360),
            "expert_length": 12, "synsets": [synset],
            "synset_to_object_ids": {synset: ids}, "broad_synset_to_object_ids": {synset: ids},
        })
    return rows


class MockEvent:
    """What `ai2thor.server.Event` offers the controller: metadata, the
    frames (drawn on first access), and truthiness = lastActionSuccess."""

    def __init__(self, metadata: Dict[str, Any], frame_seed, frame_hw, n_third_party: int = 1):
        self.metadata = metadata
        self._seed = frame_seed
        self._hw = frame_hw
        self._n_third = n_third_party
        self._frames = None

    def _draw(self):
        if self._frames is None:
            rng = np.random.default_rng(self._seed)
            h, w = self._hw
            nav = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
            third = [rng.integers(0, 256, (h, w, 4), dtype=np.uint8) for _ in range(self._n_third)]
            self._frames = (nav, third)
        return self._frames

    @property
    def frame(self) -> np.ndarray:
        return self._draw()[0]

    @property
    def third_party_camera_frames(self) -> List[np.ndarray]:
        return self._draw()[1]

    def __bool__(self) -> bool:
        return bool(self.metadata["lastActionSuccess"])


_NOOP_ACTIONS = {
    "Pass", "AdvancePhysicsStep", "SetRandomSeed", "RotateCameraMount", "ChangeFOV",
    "SetGripperOpenness", "ToggleMagnetVisibility", "SetObjectFilter", "UpdateThirdPartyCamera",
    "DisableSecondaryCamera", "ResetMaterials", "RandomizeMaterials", "VisualizeWaypoints",
    "VisualizePath", "HideVisualizedPath",
}


class MockTHOR:
    """Stands in for `ai2thor.controller.Controller`."""

    seed = 0  # frames' seed; set on the class to vary a run

    def __init__(self, **kwargs):
        self.init_kwargs = kwargs
        self.frame_hw = (kwargs.get("height", 224), kwargs.get("width", 396))
        self.calls: List[Dict[str, Any]] = []
        self.scene: Optional[Dict[str, Any]] = None
        self._third_party = 1
        self._load(make_house())
        self.last_event = self._event(True)

    # -- world -------------------------------------------------------------
    def _load(self, scene):
        self.scene = scene
        agent = scene.get("metadata", {}).get("agent", AGENT_POSE0)
        self.pos = dict(agent["position"])
        self.rot = float(agent["rotation"]["y"])
        self.lift, self.extend, self.wrist = 0.5, 0.1, 0.0
        self.held: List[str] = []
        self.objects = [
            {
                "objectId": o["id"], "name": o.get("assetId", o["id"]), "objectType": o["objectType"],
                "position": dict(o["position"]), "rotation": dict(o.get("rotation", {"x": 0, "y": 0, "z": 0})),
                "pickupable": bool(o.get("pickupable", False)),
            }
            for o in scene.get("objects", [])
        ]
        polys = [[(p["x"], p["z"]) for p in r["floorPolygon"]] for r in scene.get("rooms", []) if "floorPolygon" in r]
        self._rooms = polys
        xs = [x for p in polys for x, _ in p] or [0.0, 8.0]
        zs = [z for p in polys for _, z in p] or [0.0, 4.0]
        self._reachable = [
            {"x": float(x), "y": 0.9, "z": float(z)}
            for x in np.arange(min(xs) + GRID, max(xs), GRID)
            for z in np.arange(min(zs) + GRID, max(zs), GRID)
            if self._inside(x, z)
        ]

    def _inside(self, x, z) -> bool:
        if not self._rooms:
            return True
        return any(min(p[0] for p in r) < x < max(p[0] for p in r) and min(p[1] for p in r) < z < max(p[1] for p in r)
                   for r in self._rooms)

    def _hand(self) -> Dict[str, float]:
        yaw = math.radians(self.rot + 90)  # the arm reaches out to the agent's right
        reach = 0.3 + self.extend
        return {"x": self.pos["x"] + reach * math.sin(yaw), "y": self.lift + 0.1, "z": self.pos["z"] + reach * math.cos(yaw)}

    def _dist(self, a, b) -> float:
        return math.sqrt((a["x"] - b["x"]) ** 2 + (a["y"] - b["y"]) ** 2 + (a["z"] - b["z"]) ** 2)

    def _visible(self, max_distance: float, third_party: bool = False) -> List[str]:
        """Objects within max_distance and 45 degrees of the camera's axis
        (the arm camera looks along the arm)."""
        axis = self.rot + (90 if third_party else 0)
        out = []
        for o in self.objects:
            dx, dz = o["position"]["x"] - self.pos["x"], o["position"]["z"] - self.pos["z"]
            if math.hypot(dx, dz) > max_distance:
                continue
            off = (math.degrees(math.atan2(dx, dz)) - axis + 180) % 360 - 180
            if abs(off) <= 45:
                out.append(o["objectId"])
        return out

    def _objects_meta(self):
        out = []
        visible = set(self._visible(1.5))
        for o in self.objects:
            m = copy.deepcopy(o)
            m["distance"] = self._dist(self.pos, o["position"])
            m["visible"] = o["objectId"] in visible
            m["axisAlignedBoundingBox"] = {"center": dict(o["position"]), "size": {"x": 0.2, "y": 0.2, "z": 0.2}}
            out.append(m)
        return out

    def _event(self, success: bool, error: str = "", action_return=None) -> MockEvent:
        hand = self._hand()
        pickupable = [o["objectId"] for o in self.objects
                      if o["pickupable"] and o["objectId"] not in self.held and self._dist(hand, o["position"]) < 0.3]
        meta = {
            "lastActionSuccess": success,
            "errorMessage": error,
            "collided": "collided" in error.lower(),
            "actionReturn": action_return,
            "agent": {
                "position": dict(self.pos), "rotation": {"x": 0.0, "y": self.rot, "z": 0.0},
                "cameraHorizon": 0, "isStanding": True,
            },
            "arm": {
                "heldObjects": list(self.held),
                "pickupableObjects": pickupable,
                "handSphereCenter": hand,
                "joints": [
                    {"name": "stretch_robot_lift_jnt", "rootRelativePosition": {"x": 0.0, "y": self.lift, "z": 0.0}},
                    {"name": "stretch_robot_arm_jnt", "rootRelativePosition": {"x": 0.0, "y": self.lift, "z": self.extend / 2}},
                    {"name": "stretch_robot_wrist_2_jnt",
                     "rootRelativePosition": {"x": 0.0, "y": self.lift, "z": self.extend},
                     "rootRelativeRotation": {"w": 1.0, "x": 0.0, "y": self.wrist, "z": 0.0}},
                ],
            },
            "objects": self._objects_meta(),
            "thirdPartyCameras": [{"fieldOfView": 59}] * self._third_party,
            "sceneBounds": {"size": {"x": 8.0, "y": 3.0, "z": 4.0}},
        }
        pose_key = (round(self.pos["x"] * 100), round(self.pos["z"] * 100), round(self.rot * 10) % 3600,
                    round(self.lift * 100), round(self.extend * 100), len(self.held))
        seed = [self.seed] + [k % (1 << 31) for k in pose_key]
        return MockEvent(meta, seed, self.frame_hw, self._third_party)

    # -- actions -------------------------------------------------------------
    def _move(self, distance: float):
        rad = math.radians(self.rot)
        x, z = self.pos["x"] + distance * math.sin(rad), self.pos["z"] + distance * math.cos(rad)
        if not self._inside(x, z):
            return self._event(False, "Collided with the wall 'Wall|0' while moving")
        for o in self.objects:
            if o["objectId"] not in self.held and math.hypot(o["position"]["x"] - x, o["position"]["z"] - z) < OBJECT_RADIUS:
                # the bump pushes the object a little along the motion
                o["position"]["x"] += 0.15 * math.sin(rad)
                o["position"]["z"] += 0.15 * math.cos(rad)
                return self._event(False, f"Collided with '{o['name']}' while moving")
        self.pos = {"x": float(x), "y": self.pos["y"], "z": float(z)}
        return self._event(True)

    def step(self, action=None, **kwargs):
        if isinstance(action, dict):
            kwargs = {**action, **kwargs}
            action = kwargs.pop("action")
        elif action is None:
            action = kwargs.pop("action")
        self.calls.append({"action": action, **copy.deepcopy(kwargs)})
        if action in _NOOP_ACTIONS:
            ev = self._event(True)
        elif action in ("MoveAgent", "MoveAheadQuick", "MoveBackQuick"):
            d = kwargs["ahead"] if action == "MoveAgent" else kwargs["moveMagnitude"]
            ev = self._move(-d if action == "MoveBackQuick" else d)
        elif action in ("RotateAgent", "RotateRightQuick"):
            self.rot = (self.rot + kwargs["degrees"]) % 360
            ev = self._event(True)
        elif action == "MoveArm":
            p = kwargs["position"]
            lift = min(max(p["y"] + ARM_BASE, LIFT_RANGE[0]), LIFT_RANGE[1])
            extend = min(max(p["z"], EXTEND_RANGE[0]), EXTEND_RANGE[1])
            self.lift, self.extend = lift, extend
            ev = self._event(True)
        elif action == "RotateWristRelative":
            self.wrist = math.fmod(self.wrist + kwargs["yaw"], 360)
            ev = self._event(True)
        elif action == "PickupObject":
            hand = self._hand()
            near = [o for o in self.objects if o["pickupable"] and o["objectId"] not in self.held
                    and self._dist(hand, o["position"]) < 0.3]
            if near:
                self.held.append(near[0]["objectId"])
            ev = self._event(bool(near), "" if near else "No object within range to pick up")
        elif action == "ReleaseObject":
            self.held = []
            ev = self._event(True)
        elif action == "Teleport":
            p = kwargs["position"]
            x, z = (p["x"], p["z"]) if isinstance(p, dict) else (p[0], p[2])
            y = p["y"] if isinstance(p, dict) else p[1]
            if not self._inside(x, z):
                ev = self._event(False, f"Teleport target ({x}, {z}) is outside the house")
            else:
                self.pos = {"x": float(x), "y": float(y), "z": float(z)}
                r = kwargs.get("rotation", {"y": self.rot})
                self.rot = float(r["y"] if isinstance(r, dict) else r) % 360
                ev = self._event(True)
        elif action == "GetReachablePositions":
            ev = self._event(True, action_return=copy.deepcopy(self._reachable))
        elif action == "GetVisibleObjects":
            third = kwargs.get("thirdPartyCameraIndex") is not None
            ev = self._event(True, action_return=self._visible(kwargs["maxDistance"], third))
        elif action == "GetShortestPath":
            target = next((o for o in self.objects if o["objectId"] == kwargs["objectId"]), None)
            start = kwargs.get("position", self.pos)
            if target is None:
                ev = self._event(False, f"Object {kwargs['objectId']} not found")
            else:
                mid = {"x": target["position"]["x"], "y": start["y"], "z": start["z"]}
                ev = self._event(True, action_return={"corners": [dict(start), mid, dict(target["position"])]})
        elif action == "GetMapViewCameraProperties":
            ev = self._event(True, action_return={
                "position": {"x": 4.0, "y": 3.0, "z": 2.0}, "rotation": {"x": 90.0, "y": 0.0, "z": 0.0},
                "orthographicSize": 2.5,
            })
        elif action == "AddThirdPartyCamera":
            self._third_party += 1
            ev = self._event(True)
        else:
            raise ValueError(f"the mock ai2thor backend does not answer {action!r}")
        self.last_event = ev
        return ev

    def reset(self, scene=None, **kwargs):
        self.calls.append({"action": "__reset__", "scene": copy.deepcopy(scene)})
        self._load(copy.deepcopy(scene))
        self.last_event = self._event(True)
        return self.last_event

    def stop(self):
        self.calls.append({"action": "__stop__"})


class FifoServer:
    """Placeholder for `ai2thor.fifo_server.FifoServer` (only named)."""


def install(modules) -> types.ModuleType:
    """Put the mock `ai2thor`, `ai2thor.controller` and `ai2thor.fifo_server`
    into `modules`, a dict (`sys.modules`) or a `ModuleSetter`."""
    root = types.ModuleType("ai2thor")
    ctrl = types.ModuleType("ai2thor.controller")
    ctrl.Controller = MockTHOR
    fifo = types.ModuleType("ai2thor.fifo_server")
    fifo.FifoServer = FifoServer
    root.controller, root.fifo_server = ctrl, fifo
    for name, mod in (("ai2thor", root), ("ai2thor.controller", ctrl), ("ai2thor.fifo_server", fifo)):
        modules[name] = mod
    return root


class ModuleSetter:
    """`install(ModuleSetter(monkeypatch))`: set the modules through pytest's
    monkeypatch, so they are removed after the test."""

    def __init__(self, monkeypatch):
        self.monkeypatch = monkeypatch

    def __setitem__(self, name, mod):
        import sys

        self.monkeypatch.setitem(sys.modules, name, mod)


class _HashT5Tokenizer:
    """The hash tokenizer's ids (word -> md5 bucket, EOS 1)."""

    def encode(self, text: str) -> List[int]:
        ids = [3 + int(hashlib.md5(w.encode()).hexdigest(), 16) % (32128 - 3) for w in text.lower().split()]
        return ids + [1]


def text_tokenizer() -> types.ModuleType:
    """A `transformers` module whose AutoTokenizer loads `_HashT5Tokenizer`."""
    mod = types.ModuleType("transformers")
    mod.AutoTokenizer = types.SimpleNamespace(from_pretrained=lambda *a, **k: _HashT5Tokenizer())
    return mod
