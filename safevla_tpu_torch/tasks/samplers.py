"""Task samplers: controller lifecycle + task construction.

Counterpart of the reference's `AbstractSPOCTaskSampler` / `MultiTaskSampler`
(reference: tasks/abstract_task_sampler.py:25-250,
tasks/multi_task_eval_sampler.py:27-247): owns a simulator controller, resets
houses (with physics settling + self-healing reallocation on simulator
timeouts), teleports the agent to the spec's start pose, and instantiates the
registered task class.
"""

from __future__ import annotations

import gc
import random
from typing import Any, Dict, List, Optional, Type, Union

from safevla_tpu_torch.constants import HORIZON, PHYSICS_SETTLING_TIME
from safevla_tpu_torch.tasks.registry import REGISTERED_TASKS
from safevla_tpu_torch.tasks.task_specs import TaskSpec, TaskSpecSampler
from safevla_tpu_torch.types import REGISTERED_TASK_PARAMS


class HouseInvalidForTaskException(Exception):
    pass


class TaskSamplerInInvalidStateError(Exception):
    pass


class SPOCTaskSampler:
    """Base sampler: house cache, controller allocation & self-healing."""

    def __init__(
        self,
        task_args: Dict[str, Any],
        houses: List[Dict],
        house_inds: List[int],
        controller_args: Dict,
        controller_type: Type,
        prob_randomize_materials: float = 0,
        device: Optional[int] = None,
        controller=None,
        always_allocate_a_new_stretch_controller_when_reset: bool = False,
        settle_physics_for_second_when_reset: float = PHYSICS_SETTLING_TIME,
        mode: str = "train",
        seed: Optional[int] = None,
        **kwargs: Any,
    ) -> None:
        self.mode = mode
        self.controller_type = controller_type
        self.controller_args = controller_args
        self._given_controller = controller
        self._controller = controller
        self.always_allocate_new = always_allocate_a_new_stretch_controller_when_reset
        self.settle_physics_seconds = settle_physics_for_second_when_reset

        assert len(houses) == len(house_inds)
        local = {h: i for i, h in enumerate(house_inds)}
        self._houses = houses
        self._house_local_index = local
        self.house_inds = house_inds
        self.prob_randomize_materials = prob_randomize_materials
        self.task_args = task_args
        self._last_sampled_task = None

        if mode in ("val", "test"):
            self.set_seed(seed if seed is not None else 0)
        if device is not None and device != -1:
            self.controller_args = {**self.controller_args, "gpu_device": device}

    # ------------------------------------------------------------------
    def set_seed(self, seed: int):
        random.seed(seed)
        try:
            import numpy as np

            np.random.seed(seed)
        except ImportError:
            pass

    def house_for_index(self, house_index: int) -> Dict:
        return self._houses[self._house_local_index[house_index]]

    @property
    def controller(self):
        if self._controller is None:
            try:
                self._controller = self.controller_type(**self.controller_args)
            except Exception as e:
                if e.args and "Unity process has exited" in str(e.args[0]):
                    raise TaskSamplerInInvalidStateError("Controller has closed.")
                raise
        return self._controller

    def close(self):
        if self._given_controller is None and self._controller is not None:
            self._controller.stop()

    @property
    def last_sampled_task(self):
        return self._last_sampled_task

    # ------------------------------------------------------------------
    def allocate_a_new_controller(self):
        """Self-healing: drop the (possibly dead) simulator and start fresh
        (reference abstract_task_sampler.py:205-225)."""
        if self._controller is not None:
            try:
                self._controller.stop()
            except Exception:
                pass
        self._controller = None
        gc.collect()
        try:
            self._controller = self.controller_type(**self.controller_args)
        except TimeoutError:
            self._controller = None
            gc.collect()
            self._controller = self.controller_type(**self.controller_args)

    def reset_controller_in_house(
        self, house: Dict, skip_controller_reset: bool = False
    ) -> None:
        if not skip_controller_reset:
            if self.always_allocate_new:
                self.allocate_a_new_controller()
            if house is None:
                raise HouseInvalidForTaskException("Current house is None.")
            try:
                self.controller.reset(scene=house)
            except TimeoutError:
                self.allocate_a_new_controller()
                self.controller.reset(scene=house)
            except ValueError as e:
                if e.args and "write to closed file" in str(e.args[0]):
                    raise TaskSamplerInInvalidStateError("Controller has closed.")
                raise
            if self.settle_physics_seconds > 0:
                self.controller.step(
                    action="AdvancePhysicsStep",
                    simSeconds=self.settle_physics_seconds,
                    raise_for_failure=True,
                )
        self.randomize_materials()

    def randomize_materials(self):
        if random.random() < self.prob_randomize_materials:
            self.controller.step(action="RandomizeMaterials", raise_for_failure=True)
        else:
            self.controller.step(action="ResetMaterials", raise_for_failure=True)


class MultiTaskSampler(SPOCTaskSampler):
    """Spec-driven sampler: pulls TaskSpecs, resets/skips scene reloads for
    consecutive nav-only tasks in the same house, teleports, builds the task."""

    NAV_ONLY_TASK_TYPES = ("ObjectNavType",)

    def __init__(
        self,
        mode: str,
        task_args: Dict[str, Any],
        houses: List[Dict[str, Any]],
        house_inds: List[int],
        controller_args: Dict[str, Any],
        controller_type: Type,
        task_spec_sampler: TaskSpecSampler,
        visualize: bool = False,
        prob_randomize_materials: float = 0,
        device: Optional[int] = None,
        **kwargs: Any,
    ) -> None:
        super().__init__(
            task_args=task_args,
            houses=houses,
            house_inds=house_inds,
            controller_args=controller_args,
            controller_type=controller_type,
            prob_randomize_materials=prob_randomize_materials,
            device=device,
            mode=mode,
            **kwargs,
        )
        self.mode = mode.strip().lower()
        assert self.mode in ("train", "val", "test")
        self.task_spec_sampler = task_spec_sampler
        self.visualize = visualize
        assert self.mode == "train" or prob_randomize_materials == 0

    @property
    def current_task_spec(self) -> Optional[TaskSpec]:
        return self.task_spec_sampler.last_task_spec

    @property
    def length(self) -> Union[int, float]:
        return self.task_spec_sampler.num_remaining()

    @property
    def current_house_index(self) -> int:
        return self.current_task_spec.get("house_index")

    @staticmethod
    def task_spec_to_task_info(
        task_spec: TaskSpec, house_index: int, house: Dict[str, Any]
    ) -> Dict[str, Any]:
        pos = task_spec["agent_starting_position"]
        task_info = {
            "task_type": task_spec["task_type"],
            "house_index": str(house_index),
            "num_rooms": len(house.get("rooms", [])),
            "agent_starting_position": {"x": pos[0], "y": pos[1], "z": pos[2]},
            "agent_y_rotation": task_spec["agent_y_rotation"],
            "natural_language_spec": task_spec["natural_language_spec"],
        }
        if "eval_info" in task_spec:
            task_info["eval_info"] = task_spec["eval_info"]
        required = REGISTERED_TASK_PARAMS.get(task_spec["task_type"], [])
        for key in required:
            if key in task_spec:
                task_info[key] = task_spec[key]
        missing = set(required) - set(task_spec.keys())
        if missing:
            raise NotImplementedError(
                f"Task spec for {task_spec['task_type']} is missing required keys: {missing}"
            )
        return task_info

    def increment_task_and_reset_house(
        self, force_advance_scene: bool, house_index: Optional[int] = None
    ):
        last_spec = self.current_task_spec or {"house_index": -1, "task_type": ""}
        new_spec = self.task_spec_sampler.next_task_spec(
            force_advance_scene=force_advance_scene, house_index=house_index
        )
        house_changed = last_spec["house_index"] != new_spec["house_index"]
        nav_only = (
            last_spec["task_type"] in self.NAV_ONLY_TASK_TYPES
            and new_spec["task_type"] in self.NAV_ONLY_TASK_TYPES
        )
        self.reset_controller_in_house(
            self.house_for_index(new_spec["house_index"]),
            skip_controller_reset=self.mode == "train"
            and not house_changed
            and nav_only,
        )

    def next_task(
        self, force_advance_scene: bool = False, house_index: Optional[int] = None
    ):
        if self.length == 0:
            return None
        try:
            self.increment_task_and_reset_house(force_advance_scene, house_index)
        except StopIteration:
            return None
        assert house_index is None or self.current_house_index == house_index

        task_info = self.task_spec_to_task_info(
            self.current_task_spec,
            self.current_house_index,
            self.house_for_index(self.current_house_index),
        )
        task_info["extras"] = {}

        starting_pose = dict(
            position=task_info["agent_starting_position"],
            rotation={"x": 0, "y": task_info["agent_y_rotation"], "z": 0},
            horizon=HORIZON,
            standing=True,
        )
        try:
            event = self.controller.teleport_agent(**starting_pose)
        except TimeoutError:
            self.allocate_a_new_controller()
            self.reset_controller_in_house(
                self.house_for_index(self.current_house_index)
            )
            return self.next_task(force_advance_scene, house_index)

        if not event:
            if self.mode == "train":
                # retry once after a fresh scene reset, then skip the spec
                self.controller.reset(self.house_for_index(self.current_house_index))
                event = self.controller.teleport_agent(**starting_pose)
                self.controller.calibrate_agent()
                if not event:
                    return self.next_task(force_advance_scene, house_index)
            else:
                raise RuntimeError(
                    f"Teleport failed in house {self.current_house_index} at {starting_pose}"
                )

        task_cls = REGISTERED_TASKS.get(task_info["task_type"])
        if task_cls is None:
            raise KeyError(f"Unregistered task type: {task_info['task_type']}")
        self._last_sampled_task = task_cls(
            controller=self.controller,
            task_info=task_info,
            **self.task_args,
            house=self.house_for_index(self.current_house_index),
            visualize=self.visualize,
            task_sampler=self,
        )
        return self._last_sampled_task

    def reset(self):
        self.task_spec_sampler.reset()
