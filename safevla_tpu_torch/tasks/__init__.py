"""Task layer: registry, samplers and the ObjectNav task family.

Copies of `safevla_tpu/tasks/{registry,task_specs,samplers,base,cost_model,
rewards,object_nav}.py` (only their imports differ). The registry holds the
ObjectNav family alone: the fetch, room-visit, multi-nav and probe families
are not ported yet.
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
