"""Trace-record/replay controllers: run the task/cost/reward stack against
recorded simulator states without a Unity binary.

Copy of `safevla_tpu/envs/replay_controller.py`, writing and reading the same
gzip-JSONL traces, so a trace either package records replays in the other:

  * `RecordingController` wraps any live controller (`StretchController`, or
    `FakeController` for self-tests) and snapshots every state query the
    task/cost/reward stack performs, after each reset, agent step and
    teleport.
  * `ReplayController` serves those snapshots back through the
    `BaseController` interface, so the tasks, cost model and reward shapers
    run against the recorded states, and asserts that the task issues the
    recorded actions in order.

Two repairs over the JAX copy, both where it raises: the recorder forwards a
teleport's `forceAction` by keyword (`StretchController.teleport_agent` takes
it only so), and the trace header stores a room polygon (`Polygon2D`, what
`StretchController` keeps per room) as its list of (x, z) points. Traces the
JAX package can write come out byte for byte the same.
"""

from __future__ import annotations

import gzip
import json
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from safevla_tpu_torch.envs.controller_base import BaseController, Event
from safevla_tpu_torch.envs.geometry import Polygon2D


def _jsonable(x):
    if isinstance(x, Polygon2D):
        return [list(p) for p in x.points]
    if isinstance(x, (np.integer,)):
        return int(x)
    if isinstance(x, (np.floating,)):
        return float(x)
    if isinstance(x, np.ndarray):
        return x.tolist()
    if isinstance(x, dict):
        return {k: _jsonable(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_jsonable(v) for v in x]
    return x


class RecordingController:
    """Pass-through wrapper that snapshots the full query surface after every
    state change (reset / agent_step / teleport).

    Deliberately NOT a BaseController subclass: every method not overridden
    here must fall through __getattr__ to the live controller (the base
    class's NotImplementedError stubs would shadow it)."""

    def __init__(self, inner: BaseController, target_object_ids: List[str]):
        self.inner = inner
        self.targets = list(target_object_ids)
        self.frames: List[Dict[str, Any]] = []
        self._last_event: Optional[Dict[str, Any]] = None

    # -- snapshotting -------------------------------------------------------
    def _snapshot(self, action: Optional[str], event: Event) -> None:
        inner = self.inner
        pose = inner.get_current_agent_full_pose()
        meta = getattr(event, "metadata", None) or {}
        snap: Dict[str, Any] = {
            "action": action,
            "event": {
                "success": bool(event),
                "errorMessage": str(meta.get("errorMessage", "")),
                "collided": bool(meta.get("collided", False)),
            },
            "agent_pose": pose,
            "objects": inner.get_objects(),
            "held": inner.get_held_objects(),
            "in_hand_sphere": inner.get_objects_in_hand_sphere(),
            "visible_4m": inner.get_visible_objects(maximum_distance=4),
            "visible_in_nav_2m": [
                oid
                for oid in self.targets
                if self._safe(
                    lambda: inner.object_is_visible_in_camera(
                        oid, which_camera="nav", maximum_distance=2
                    ),
                    False,
                )
            ],
            "arm_sphere_dists": {
                oid: self._safe(lambda: inner.dist_from_arm_sphere_center_to_obj(oid), 99.0)
                for oid in self.targets
            },
            "arm_sphere_collider_dists": {
                oid: self._safe(
                    lambda: inner.dist_from_arm_sphere_center_to_obj_colliders_closest_to_point(
                        oid
                    ),
                    99.0,
                )
                for oid in self.targets
            },
            "agent_room": self._safe(
                lambda: inner.get_room_id_from_location(pose["position"]), None
            ),
        }
        self.frames.append(_jsonable(snap))

    @staticmethod
    def _safe(fn, default):
        try:
            return fn()
        except Exception:
            return default

    def save(self, path: str, extra: Optional[Dict[str, Any]] = None) -> str:
        header = {
            "kind": "safevla_thor_trace",
            "version": 1,
            "targets": self.targets,
            "reachable_positions": _jsonable(
                self._safe(self.inner.get_reachable_positions, [])
            ),
            "room_poly_map": _jsonable(self.inner.room_poly_map),
            "room_type_dict": _jsonable(self.inner.room_type_dict),
            **(extra or {}),
        }
        with gzip.open(path, "wt") as f:
            f.write(json.dumps(header) + "\n")
            for fr in self.frames:
                f.write(json.dumps(fr) + "\n")
        return path

    # -- pass-through controller surface -------------------------------------
    def reset(self, scene, seed=None) -> Event:
        ev = self.inner.reset(scene, seed)
        self.frames.clear()
        self._snapshot(None, ev)
        return ev

    def agent_step(self, action: str) -> Event:
        ev = self.inner.agent_step(action)
        self._snapshot(action, ev)
        return ev

    def teleport_agent(self, position, rotation, horizon=0, standing=True, forceAction=False):
        ev = self.inner.teleport_agent(
            position, rotation, horizon, standing, forceAction=forceAction
        )
        if self.frames:
            self.frames.pop()  # teleport replaces the initial snapshot
        self._snapshot(None, ev)
        return ev

    def __getattr__(self, name):
        return getattr(self.inner, name)

    @property
    def navigation_camera(self):
        return self.inner.navigation_camera

    @property
    def manipulation_camera(self):
        return self.inner.manipulation_camera

    @property
    def room_poly_map(self):
        return self.inner.room_poly_map

    @property
    def room_type_dict(self):
        return self.inner.room_type_dict


class ReplayController(BaseController):
    """Serves a recorded trace through the BaseController interface. The task
    must issue exactly the recorded action sequence (asserted)."""

    def __init__(self, path: str):
        with gzip.open(path, "rt") as f:
            lines = f.read().splitlines()
        self.header = json.loads(lines[0])
        assert self.header.get("kind") == "safevla_thor_trace", path
        self.frames = [json.loads(l) for l in lines[1:]]
        self.cursor = 0
        self.room_poly_map = {
            k: tuple(v) if isinstance(v, list) else v
            for k, v in self.header.get("room_poly_map", {}).items()
        }
        self.room_type_dict = self.header.get("room_type_dict", {})
        self._frame = np.zeros((224, 384, 3), np.uint8)

    @property
    def cur(self) -> Dict[str, Any]:
        return self.frames[self.cursor]

    def remaining_actions(self) -> List[str]:
        return [f["action"] for f in self.frames[self.cursor + 1 :]]

    # -- lifecycle -----------------------------------------------------------
    def reset(self, scene, seed=None) -> Event:
        self.cursor = 0
        return Event(True)

    def teleport_agent(self, position, rotation, horizon=0, standing=True, forceAction=False):
        return Event(True)

    def calibrate_agent(self) -> None:
        pass

    def stop(self) -> None:
        pass

    def agent_step(self, action: str) -> Event:
        nxt = self.frames[self.cursor + 1]
        assert nxt["action"] == action, (
            f"replay divergence at step {self.cursor + 1}: trace has "
            f"{nxt['action']!r}, task issued {action!r}"
        )
        self.cursor += 1
        ev = nxt["event"]
        return Event(
            ev["success"],
            {"errorMessage": ev["errorMessage"], "collided": ev["collided"]},
        )

    # -- state queries (served from the current snapshot) ---------------------
    def get_current_agent_position(self):
        return dict(self.cur["agent_pose"]["position"])

    def get_current_agent_full_pose(self):
        return json.loads(json.dumps(self.cur["agent_pose"]))

    def get_arm_proprioception(self):
        return self.cur.get("arm_proprioception", [0.0] * 4)

    def get_objects(self):
        return json.loads(json.dumps(self.cur["objects"]))

    def get_obj_pos_from_obj_id(self, object_id):
        for o in self.cur["objects"]:
            if o["objectId"] == object_id:
                return dict(o["position"])
        raise KeyError(object_id)

    def get_held_objects(self):
        return list(self.cur["held"])

    def get_objects_in_hand_sphere(self):
        return list(self.cur["in_hand_sphere"])

    def get_visible_objects(self, maximum_distance: float = 4):
        assert maximum_distance == 4, "trace records the 4m visibility set"
        return list(self.cur["visible_4m"])

    def object_is_visible_in_camera(self, object_id, which_camera="nav", maximum_distance=2):
        assert which_camera == "nav" and maximum_distance == 2, (
            "trace records nav-camera 2m visibility for target objects"
        )
        return object_id in self.cur["visible_in_nav_2m"]

    def dist_from_arm_sphere_center_to_obj(self, object_id):
        return float(self.cur["arm_sphere_dists"][object_id])

    def dist_from_arm_sphere_center_to_obj_colliders_closest_to_point(self, object_id):
        return float(self.cur["arm_sphere_collider_dists"][object_id])

    def get_room_id_from_location(self, position) -> Optional[str]:
        return self.cur.get("agent_room")

    def get_reachable_positions(self):
        return json.loads(json.dumps(self.header.get("reachable_positions", [])))

    def get_closest_object_from_ids(self, object_ids, return_id_and_dist=True):
        apos = self.get_current_agent_position()
        best: Tuple[Optional[str], float] = (None, float("inf"))
        for o in self.cur["objects"]:
            if o["objectId"] in object_ids:
                d = (
                    (o["position"]["x"] - apos["x"]) ** 2
                    + (o["position"]["z"] - apos["z"]) ** 2
                ) ** 0.5
                if d < best[1]:
                    best = (o["objectId"], d)
        return best if return_id_and_dist else best[0]

    def get_all_objects_of_synset(self, synset, include_hyponyms=True):
        word = synset.split(".")[0].lower()
        return [o for o in self.cur["objects"] if o["objectType"].lower() == word]

    def reset_visibility_cache(self) -> None:
        pass

    # -- cameras (not part of the recorded surface) ---------------------------
    @property
    def navigation_camera(self):
        return self._frame

    @property
    def manipulation_camera(self):
        return self._frame
