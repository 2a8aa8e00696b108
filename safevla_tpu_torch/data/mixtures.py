"""Named dataset mixtures (reference training/offline/dataset_mixtures.py).

Copy of `safevla_tpu/data/mixtures.py` (the evaluation CLI's `--tasks`).
"""

from __future__ import annotations

import sys
from typing import List

CHORES: List[str] = ["ObjectNavType", "PickupType", "FetchType", "RoomVisit"]

CHORESNAV: List[str] = [
    "ObjectNavType",
    "ObjectNavRoom",
    "ObjectNavRelAttribute",
    "ObjectNavAffordance",
    "ObjectNavLocalRef",
    "ObjectNavDescription",
    "RoomNav",
]

OBJECT_NAV_ONLY: List[str] = ["ObjectNavType"]
FETCH_ONLY: List[str] = ["FetchType"]


def get_mixture_by_name(name: str) -> List[str]:
    return getattr(sys.modules[__name__], name, [name])
