"""Lightweight 2D geometry: room polygons without a shapely dependency.

The reference uses shapely Polygons for room maps
(reference: utils/data_generation_utils/navigation_utils.py
get_room_id_from_location); here a minimal ray-casting polygon plus
point-to-polygon distance covers that surface.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple


class Polygon2D:
    def __init__(self, points_xz: Sequence[Tuple[float, float]]):
        self.points = [(float(x), float(z)) for x, z in points_xz]

    def contains(self, x: float, z: float) -> bool:
        """Ray-casting point-in-polygon."""
        inside = False
        pts = self.points
        n = len(pts)
        j = n - 1
        for i in range(n):
            xi, zi = pts[i]
            xj, zj = pts[j]
            if (zi > z) != (zj > z):
                x_at = (xj - xi) * (z - zi) / (zj - zi + 1e-12) + xi
                if x < x_at:
                    inside = not inside
            j = i
        return inside

    def distance(self, x: float, z: float) -> float:
        """0 inside; otherwise distance to the closest edge."""
        if self.contains(x, z):
            return 0.0
        best = float("inf")
        pts = self.points
        n = len(pts)
        for i in range(n):
            x1, z1 = pts[i]
            x2, z2 = pts[(i + 1) % n]
            dx, dz = x2 - x1, z2 - z1
            denom = dx * dx + dz * dz
            t = 0.0 if denom == 0 else max(
                0.0, min(1.0, ((x - x1) * dx + (z - z1) * dz) / denom)
            )
            px, pz = x1 + t * dx, z1 + t * dz
            best = min(best, math.hypot(x - px, z - pz))
        return best


def get_rooms_polymap_and_type(house: Dict) -> Tuple[Dict[str, Polygon2D], Dict[str, str]]:
    """Scene json rooms -> ({room_id: polygon}, {room_id: roomType})."""
    poly_map: Dict[str, Polygon2D] = {}
    type_map: Dict[str, str] = {}
    for room in house.get("rooms", []):
        if "floorPolygon" not in room:
            continue
        poly_map[room["id"]] = Polygon2D(
            [(p["x"], p["z"]) for p in room["floorPolygon"]]
        )
        type_map[room["id"]] = room.get("roomType", "Unknown")
    return poly_map, type_map


def get_room_id_from_location(poly_map: Dict[str, Polygon2D], position) -> str | None:
    """Closest room containing (or nearly containing) the position
    (reference navigation_utils.py:45-70)."""
    if isinstance(position, dict):
        x, z = position["x"], position["z"]
    else:
        x, z = position[0], position[2]
    dists = {}
    for room_id, poly in poly_map.items():
        d = poly.distance(x, z)
        if d == 0:
            return room_id
        dists[room_id] = d
    on_walls = [rid for rid, d in dists.items() if d < 1e-3]
    if on_walls:
        return on_walls[0]
    return None


def heading_to_target(agent_pose, target_position) -> float:
    """Signed yaw offset (degrees, wrapped to (-180, 180]) from the agent's
    heading to the target (reference navigation_utils.py:30-42 rotation_from).
    0 = facing the target; positive = target is clockwise."""
    import math

    dx = target_position["x"] - agent_pose["position"]["x"]
    dz = target_position["z"] - agent_pose["position"]["z"]
    heading = agent_pose["rotation"]["y"]
    if dx == 0 and dz == 0:
        result = heading
    else:
        result = math.degrees(math.atan2(dx, dz))
    result = (result - heading) % 360
    if result > 180:
        result -= 360
    return result
