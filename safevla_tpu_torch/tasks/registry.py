"""Task-type registry (reference tasks/__init__.py:11-37)."""

from __future__ import annotations

from typing import Dict, Type

from safevla_tpu_torch.types import REGISTERED_TASK_PARAMS

REGISTERED_TASKS: Dict[str, Type] = {}


def register_task(cls):
    """Register a task class iff its task_type_str has a param schema."""
    if cls.task_type_str in REGISTERED_TASK_PARAMS:
        REGISTERED_TASKS[cls.task_type_str] = cls
    return cls
