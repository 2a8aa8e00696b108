"""Task-spec schema and samplers (reference tasks/task_specs.py).

A TaskSpec is the serializable description of one episode: task type, house,
start pose, language instruction, and per-task parameters.
"""

from __future__ import annotations

import abc
import copy
import random
from typing import Any, Dict, List, Optional, TypedDict, Union


class TaskSpec(TypedDict, total=False):
    task_type: str
    house_index: int
    natural_language_spec: str
    agent_starting_position: List[float]  # xyz
    agent_y_rotation: float
    eval_info: Optional[Dict[str, Any]]


def map_task_type(task_type: str) -> str:
    """Legacy task-type aliases (reference utils/task_type_mapping_utils.py)."""
    return {
        "SimpleExploreHouse": "RoomVisit",
        "ObjectNavOpenVocab": "ObjectNavDescription",
    }.get(task_type, task_type)


def inverse_map_task_type(task_type: str) -> str:
    return {
        "RoomVisit": "SimpleExploreHouse",
        "ObjectNavDescription": "ObjectNavOpenVocab",
    }.get(task_type) or task_type


def map_task_spec(task_spec: TaskSpec) -> TaskSpec:
    task_spec = copy.copy(task_spec)
    task_spec["task_type"] = map_task_type(task_spec["task_type"])
    return task_spec


class TaskSpecSampler(abc.ABC):
    last_task_spec: Optional[TaskSpec]

    @abc.abstractmethod
    def next_task_spec(
        self, force_advance_scene: bool = False, house_index: Optional[int] = None
    ) -> TaskSpec:
        ...

    @abc.abstractmethod
    def __len__(self) -> Union[int, float]:
        ...

    @abc.abstractmethod
    def num_remaining(self) -> Union[int, float]:
        ...

    @abc.abstractmethod
    def reset(self):
        ...


class TaskSpecDatasetList(TaskSpecSampler):
    """Finite, sequential spec list (eval-style)."""

    def __init__(self, task_specs: List[TaskSpec]) -> None:
        self.task_specs = task_specs
        self.index = -1
        self.last_task_spec: Optional[TaskSpec] = None

    def next_task_spec(
        self, force_advance_scene: bool = False, house_index: Optional[int] = None
    ) -> TaskSpec:
        self.index += 1
        if self.index >= len(self.task_specs):
            raise StopIteration
        self.last_task_spec = map_task_spec(self.task_specs[self.index])
        return self.last_task_spec

    def __len__(self):
        return len(self.task_specs)

    def num_remaining(self):
        return len(self.task_specs) - (self.index + 1)

    def reset(self):
        self.index = -1
        self.last_task_spec = None


class TaskSpecSamplerInfiniteList(TaskSpecSampler):
    """Infinite shuffled per-house sampler with optional house stickiness
    (reference task_specs.py:149-230): keeps sampling specs from the current
    house until forced to advance, which bounds simulator scene reloads."""

    def __init__(
        self,
        house_index_to_task_specs: Dict[int, List[TaskSpec]],
        shuffle: bool,
        repeat_house_until_forced: bool,
    ) -> None:
        self.shuffle = shuffle
        self.repeat_house_until_forced = repeat_house_until_forced
        self.house_index_to_task_specs = {**house_index_to_task_specs}
        assert all(len(v) != 0 for v in self.house_index_to_task_specs.values())
        self.specs_for_current_house: List[TaskSpec] = []
        self.house_inds: List[int] = []
        self.current_house_ind: Optional[int] = None
        self.last_task_spec: Optional[TaskSpec] = None

    def _reset_house_inds(self):
        self.house_inds = list(self.house_index_to_task_specs.keys())
        if self.shuffle:
            random.shuffle(self.house_inds)

    def advance_house(self, force_advance_scene: bool, house_index: Optional[int]):
        if len(self.house_inds) == 0:
            self._reset_house_inds()
        if house_index is not None:
            if house_index not in self.house_index_to_task_specs:
                raise ValueError(f"House index {house_index} unknown")
            if house_index not in self.house_inds:
                self._reset_house_inds()
            self.house_inds.remove(house_index)
            self.current_house_ind = house_index
        elif (
            force_advance_scene
            or self.current_house_ind is None
            or not self.repeat_house_until_forced
        ):
            self.current_house_ind = self.house_inds.pop()
        self.specs_for_current_house = [
            *self.house_index_to_task_specs[self.current_house_ind]
        ]
        if self.shuffle:
            random.shuffle(self.specs_for_current_house)

    def next_task_spec(
        self, force_advance_scene: bool = False, house_index: Optional[int] = None
    ) -> TaskSpec:
        if (
            force_advance_scene
            or len(self.specs_for_current_house) == 0
            or house_index is not None
        ):
            self.advance_house(force_advance_scene, house_index)
        self.last_task_spec = map_task_spec(self.specs_for_current_house.pop())
        return self.last_task_spec

    def __len__(self):
        return float("inf")

    def num_remaining(self):
        return float("inf")

    def reset(self):
        self.specs_for_current_house.clear()
        self.house_inds.clear()
        self.current_house_ind = None
        self.last_task_spec = None


class TaskSpecQueue(TaskSpecSampler):
    """Pulls specs from a multiprocessing queue (eval worker distribution,
    reference task_specs.py:233-253)."""

    def __init__(self, queue, convert=None, timeout: float = 5.0):
        self.queue = queue
        self.convert = convert
        self.timeout = timeout
        self.last_task_spec: Optional[TaskSpec] = None

    def next_task_spec(
        self, force_advance_scene: bool = False, house_index: Optional[int] = None
    ) -> TaskSpec:
        import queue as _queue

        try:
            item = self.queue.get(timeout=self.timeout)
        except _queue.Empty:
            raise StopIteration
        self.last_task_spec = self.convert(item) if self.convert else map_task_spec(item)
        return self.last_task_spec

    def __len__(self):
        return float("inf")

    def num_remaining(self):
        return float("inf")

    def reset(self):
        self.last_task_spec = None
