"""Host-side environments: the controller interface, the simulator-free
FakeController, the AI2-THOR StretchController (`ai2thor` imported only when
one is built), the trace record/replay controllers, the robot state, its
geometry helpers, the sensors, the bounding-box sensors and Detic. Copies of
`safevla_tpu/envs/*.py`, whose imports point into the port."""

from safevla_tpu_torch.envs.controller_base import BaseController, Event
from safevla_tpu_torch.envs.fake_controller import FakeController
