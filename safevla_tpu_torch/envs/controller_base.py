"""Controller interface: the ~20-method surface tasks and sensors consume.

This is the contract extracted from the reference's `StretchController`
facade (reference: environment/stretch_controller.py:53-1282). Implementations:
  * `FakeController` (envs/fake_controller.py) — simulator-free, for tests and
    throughput benchmarking of everything above the simulator.
  * `StretchController` (envs/thor_controller.py) — the real AI2-THOR binding
    (optional dependency; rollout workers run it on CPU hosts).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np


class Event:
    """Minimal action-result event (mirrors ai2thor.server.Event truthiness)."""

    def __init__(self, success: bool, metadata: Optional[Dict[str, Any]] = None):
        self.metadata = {"errorMessage": "", "collided": False, **(metadata or {})}
        self._success = success

    def __bool__(self) -> bool:
        return self._success


class BaseController:
    """Abstract controller. All positions are {"x", "y", "z"} dicts."""

    # ---- lifecycle ----
    def reset(self, scene: Dict[str, Any], seed: Optional[int] = None) -> Event:
        raise NotImplementedError

    def stop(self) -> None:
        pass

    def calibrate_agent(self) -> None:
        pass

    # ---- actions ----
    def agent_step(self, action: str) -> Event:
        raise NotImplementedError

    def step(self, action: str, **kwargs) -> Event:
        raise NotImplementedError

    def teleport_agent(
        self, position, rotation, horizon=0, standing=True, forceAction=False
    ) -> Event:
        raise NotImplementedError

    # ---- agent state ----
    def get_current_agent_position(self) -> Dict[str, float]:
        raise NotImplementedError

    def get_current_agent_full_pose(self) -> Dict[str, Any]:
        raise NotImplementedError

    def get_arm_proprioception(self) -> List[float]:
        raise NotImplementedError

    # ---- cameras ----
    @property
    def navigation_camera(self) -> np.ndarray:
        raise NotImplementedError

    @property
    def manipulation_camera(self) -> np.ndarray:
        raise NotImplementedError

    # ---- objects ----
    def get_objects(self) -> List[Dict[str, Any]]:
        raise NotImplementedError

    def get_obj_pos_from_obj_id(self, object_id: str) -> Dict[str, float]:
        raise NotImplementedError

    def get_held_objects(self) -> List[str]:
        raise NotImplementedError

    def get_objects_in_hand_sphere(self) -> List[str]:
        raise NotImplementedError

    def get_all_objects_of_synset(
        self, synset: str, include_hyponyms: bool = True
    ) -> List[Dict[str, Any]]:
        raise NotImplementedError

    # ---- visibility ----
    def reset_visibility_cache(self) -> None:
        pass

    def get_visible_objects(self, maximum_distance: float = 4) -> List[str]:
        raise NotImplementedError

    def object_is_visible_in_camera(
        self, object_id: str, which_camera: str = "nav", maximum_distance: float = 2
    ) -> bool:
        raise NotImplementedError

    # ---- spatial queries ----
    def get_reachable_positions(self) -> List[Dict[str, float]]:
        raise NotImplementedError

    def get_closest_object_from_ids(
        self, object_ids: List[str], return_id_and_dist: bool = True
    ) -> Tuple[Optional[str], float]:
        raise NotImplementedError

    def dist_from_arm_sphere_center_to_obj(self, object_id: str) -> float:
        raise NotImplementedError

    def dist_from_arm_sphere_center_to_obj_colliders_closest_to_point(
        self, object_id: str
    ) -> float:
        raise NotImplementedError

    def get_room_id_from_location(self, position) -> Optional[str]:
        raise NotImplementedError

    # ---- house metadata ----
    room_poly_map: Dict[str, Any] = {}
    room_type_dict: Dict[str, str] = {}
