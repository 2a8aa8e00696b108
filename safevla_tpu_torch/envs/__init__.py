"""Host-side environments: the controller interface, the simulator-free
FakeController, its geometry helpers and the sensors. Copies of
`safevla_tpu/envs/{controller_base,fake_controller,geometry,sensors}.py`
(only their imports differ); the AI2-THOR controllers are not ported yet."""

from safevla_tpu_torch.envs.controller_base import BaseController, Event
from safevla_tpu_torch.envs.fake_controller import FakeController
