"""Task layer: registry + concrete tasks.

Copies of `safevla_tpu/tasks/` (only their imports differ): the registry,
task specs and samplers, and every task family of the JAX package — the
ObjectNav family, fetch / pickup, room visit, multi-target and room
navigation, and the constrained learnability probes. The registry mirrors
reference tasks/__init__.py:11-37 — a task class is registered iff its
task_type_str has a registered param schema.
"""

from safevla_tpu_torch.tasks.registry import REGISTERED_TASKS, register_task
from safevla_tpu_torch.tasks.base import SPOCTask
from safevla_tpu_torch.tasks.object_nav import (
    ObjectNavTask,
    EasyObjectNavTask,
    ObjectNavRoomTask,
    ObjectNavRelAttributeTask,
    ObjectNavLocalRefTask,
    ObjectNavAffordanceTask,
    ObjectNavDescriptionTask,
)
from safevla_tpu_torch.tasks.fetch import FetchTask, EasyFetchTask, PickupTask
from safevla_tpu_torch.tasks.room_visit import RoomVisitTask
from safevla_tpu_torch.tasks.multi_nav import ObjectNavMultiTask, RoomNavTask
from safevla_tpu_torch.tasks.probe import (
    ConstrainedBanditTask,
    InstructionBanditTask,
    make_probe_sampler_factory,
)
from safevla_tpu_torch.tasks.samplers import MultiTaskSampler, SPOCTaskSampler
from safevla_tpu_torch.tasks.task_specs import (
    TaskSpec,
    TaskSpecSampler,
    TaskSpecDatasetList,
    TaskSpecSamplerInfiniteList,
    TaskSpecQueue,
    map_task_type,
    map_task_spec,
)

__all__ = [
    "REGISTERED_TASKS",
    "register_task",
    "SPOCTask",
    "ObjectNavTask",
    "EasyObjectNavTask",
    "ObjectNavRoomTask",
    "ObjectNavRelAttributeTask",
    "ObjectNavLocalRefTask",
    "ObjectNavAffordanceTask",
    "ObjectNavDescriptionTask",
    "FetchTask",
    "EasyFetchTask",
    "PickupTask",
    "RoomVisitTask",
    "ObjectNavMultiTask",
    "RoomNavTask",
    "ConstrainedBanditTask",
    "InstructionBanditTask",
    "make_probe_sampler_factory",
    "MultiTaskSampler",
    "SPOCTaskSampler",
    "TaskSpec",
    "TaskSpecSampler",
    "TaskSpecDatasetList",
    "TaskSpecSamplerInfiniteList",
    "TaskSpecQueue",
    "map_task_type",
    "map_task_spec",
]
