"""Episode-level metrics: SEL, SPL, distances.

Semantics match reference utils/sel_utils.py:4-20,
utils/distance_calculation_utils.py:7-33, and the allenact robothor
`spl_metric` the reference imports (tasks/object_nav_task.py:4,176-180).
"""

from __future__ import annotations

import math
from typing import List, Literal, Optional

from safevla_tpu_torch.types import Vector3


def sel_metric(
    success: bool, optimal_episode_length: float, actual_episode_length: float
) -> Optional[float]:
    """Success weighted by Episode Length."""
    if not success:
        return 0.0
    if optimal_episode_length < 0:
        return None
    if optimal_episode_length == 0:
        return 1.0 if actual_episode_length == 0 else 0.0
    return optimal_episode_length / max(actual_episode_length, optimal_episode_length)


def spl_metric(
    success: bool, optimal_distance: float, travelled_distance: float
) -> Optional[float]:
    """Success weighted by Path Length."""
    if not success:
        return 0.0
    if optimal_distance < 0:
        return None
    if optimal_distance == 0:
        return 1.0 if travelled_distance == 0 else 0.0
    return optimal_distance / max(travelled_distance, optimal_distance)


def position_dist(
    p0: Vector3,
    p1: Vector3,
    ignore_y: bool = False,
    dist_fn: Literal["l1", "l2"] = "l2",
) -> float:
    if dist_fn == "l1":
        return (
            abs(p0["x"] - p1["x"])
            + (0 if ignore_y else abs(p0["y"] - p1["y"]))
            + abs(p0["z"] - p1["z"])
        )
    if dist_fn == "l2":
        return math.sqrt(
            (p0["x"] - p1["x"]) ** 2
            + (0 if ignore_y else (p0["y"] - p1["y"]) ** 2)
            + (p0["z"] - p1["z"]) ** 2
        )
    raise NotImplementedError(f"dist_fn must be l1 or l2, got {dist_fn}")


def sum_dist_path(path: List[Vector3]) -> float:
    return sum(position_dist(path[i], path[i + 1]) for i in range(len(path) - 1))


def trajectory_room_visitation(room_lookup, trajectory, num_rooms: int):
    """(fraction, count) of distinct rooms the trajectory passed through
    (reference online_evaluation_types_and_utils.py:122-130). `room_lookup`
    maps a position (dict or xyz sequence) to a room id or None."""
    visited = {room_lookup(p) for p in trajectory}
    visited.discard(None)
    return len(visited) / (num_rooms + 1e-9), len(visited)
