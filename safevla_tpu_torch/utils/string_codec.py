"""Byte <-> string codecs for shipping instructions through observation arrays.

Matches reference utils/string_utils.py:11-15: instructions cross the
host/device boundary as fixed-width uint8 arrays.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def convert_string_to_byte(s: str, max_len: int) -> np.ndarray:
    return np.array([s], dtype=f"S{max_len}").view("uint8")


def convert_byte_to_string(b: np.ndarray, max_len: Optional[int] = None) -> str:
    if max_len is None:
        max_len = b.shape[-1]
    return (b.view(f"S{max_len}")[0]).decode()
