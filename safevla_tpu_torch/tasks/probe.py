"""Learnability probe tasks: proof the constrained-RL loop optimizes.

The reference demonstrates its recipe end-to-end in AI2-THOR (reference
training/online/dinov2_vits_tsfm_base.py:310-379 is the 3-stage pipeline;
scripts/download_aligned_ckpt.py publishes the trained result). This box has
no Unity binary, so these tasks isolate the OPTIMIZER claim on
FakeController with engineered reward/cost whose constrained optimum is
known in closed form — run through the FULL production stack (sensors ->
MultiTaskSampler -> RolloutRunner -> Learner's 3-stage pipeline), nothing
mocked. Copy of `safevla_tpu/tasks/probe.py` (only its imports differ);
`chip_smoke.py`'s learning phase runs the ConstrainedBandit probe through
the port's trainer on the card and asserts the qualitative shape that
`tests/test_learning.py` asserts of the JAX package.

Two probes:

- `ConstrainedBanditTask`: per-step, action `move_ahead` pays reward 1.0 at
  safety cost 1.0; `rotate_left` pays 0.4 at cost 0. The unconstrained
  optimum sprints every step (episode cost = max_steps >> cost_limit); the
  PPO-Lagrangian optimum holds episode cost at `cost_limit`:
  expected return = cost_limit * 1.0 + (max_steps - cost_limit) * 0.4.
  A healthy run shows reward rising toward the unconstrained optimum while
  lambda ~ 0, cost overshooting `cost_limit`, lambda ascending
  (omnisafe semantics, algo/lagrange.py), the penalized advantage
  (A - lam*A_c)/(1+lam) flipping against `move_ahead`, and episode cost
  settling at the limit — the same dynamics the reference's recipe relies
  on, at 1/1000th the compute.

- `InstructionBanditTask`: the rewarded action is named BY THE INSTRUCTION
  ("turn left" -> rotate_left, "turn right" -> rotate_right), alternating
  per episode. A state-independent policy caps at 0.5 accuracy; beating it
  requires the gradient to flow through text encoding -> fusion -> decoder
  -> actor tower, i.e. the full VLA pathway learns, not just a logit bias.
"""

from __future__ import annotations

from typing import Any, Dict, List, TypedDict

import numpy as np

from safevla_tpu_torch.tasks.base import SPOCTask
from safevla_tpu_torch.tasks.registry import register_task
from safevla_tpu_torch.types import StepResult, THORActions, register_task_specific_params


@register_task_specific_params
class ConstrainedBandit(TypedDict):
    pass


@register_task_specific_params
class InstructionBandit(TypedDict):
    pass


class _ProbeTask(SPOCTask):
    """Shared lifecycle: episodes run to max_steps unless `done` is taken
    (which ends the episode unsuccessfully — the optimum never stops)."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._rewards: List[float] = []
        self._costs: List[float] = []

    # reward/cost are pure functions of the taken action (+ instruction);
    # judge() is unused because _step computes the reward directly
    def judge(self) -> float:
        return self._rewards[-1] if self._rewards else 0.0

    def successful_if_done(self, strict_success: bool = False) -> bool:
        return False

    @property
    def cumulative_cost(self) -> float:
        return float(np.sum(self._costs))

    def _reward_cost_for(self, action_str: str):
        raise NotImplementedError

    def _step(self, action: int) -> StepResult:
        action_str = self.action_names[action]
        self.last_taken_action_str = action_str
        reward, cost = 0.0, 0.0
        if action_str == THORActions.done:
            self._took_end_action = True
            self._success = False
            self.last_action_success = False
        else:
            # drive the real controller so frames/pose evolve and the
            # observation pipeline does its production work
            event = self.controller.agent_step(action=action_str)
            self.last_action_success = bool(event)
            self.error_message = event.metadata["errorMessage"].lower()
            reward, cost = self._reward_cost_for(action_str)
        self._rewards.append(reward)
        self._costs.append(cost)
        return StepResult(
            observation=self.get_observations(),
            reward=reward,
            cost=cost,
            done=self.is_done(),
            info={
                "last_action_success": self.last_action_success,
                "action": action,
                "collided": False,
                "errorMessage": self.error_message,
            },
        )

    def metrics(self) -> Dict[str, Any]:
        if not self.is_done():
            return {}
        metrics = {
            "success": bool(self._success),
            "total_reward": float(np.sum(self._rewards)),
            "cost": self.cumulative_cost,
            "ep_length": self.num_steps_taken(),
            "task_info": self.task_info,
        }
        self._metrics = metrics
        return metrics


@register_task
class ConstrainedBanditTask(_ProbeTask):
    task_type_str = "ConstrainedBandit"

    RISKY_ACTION = THORActions.move_ahead
    SAFE_ACTION = THORActions.rotate_left
    RISKY_REWARD = 1.0
    SAFE_REWARD = 0.4
    RISKY_COST = 1.0

    def _reward_cost_for(self, action_str: str):
        if action_str == self.RISKY_ACTION:
            return self.RISKY_REWARD, self.RISKY_COST
        if action_str == self.SAFE_ACTION:
            return self.SAFE_REWARD, 0.0
        return 0.0, 0.0

    @classmethod
    def optima(cls, max_steps: int, cost_limit: float) -> Dict[str, float]:
        """Closed-form per-episode returns the curves are judged against."""
        risky_steps = min(cost_limit / cls.RISKY_COST, max_steps)
        return {
            "unconstrained_return": max_steps * cls.RISKY_REWARD,
            "constrained_return": risky_steps * cls.RISKY_REWARD
            + (max_steps - risky_steps) * cls.SAFE_REWARD,
            "safe_only_return": max_steps * cls.SAFE_REWARD,
            "unconstrained_cost": max_steps * cls.RISKY_COST,
        }


@register_task
class InstructionBanditTask(_ProbeTask):
    task_type_str = "InstructionBandit"

    REWARD = 1.0
    INSTRUCTION_TO_ACTION = {
        "turn left": THORActions.rotate_left,
        "turn right": THORActions.rotate_right,
    }

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        spec = self.task_info["natural_language_spec"]
        self._target_action = self.INSTRUCTION_TO_ACTION[spec]

    def _reward_cost_for(self, action_str: str):
        if action_str == self._target_action:
            return self.REWARD, 0.0
        return 0.0, 0.0


def probe_train_config(
    updates: int,
    task_type: str = "ConstrainedBandit",
    streams: int = 4,
    rollout_steps: int = 16,
    episode_steps: int = 16,
    cost_limit: float = 4.0,
    warmup_updates: int = 25,
):
    """Probe-scale Config: tiny towers, the reference's 3-stage shape
    (critic warmup -> PPO-Lagrangian) scaled to `updates` rollout windows.
    Used by chip_smoke.py's learning phase."""
    from safevla_tpu_torch.config import Config, ModelConfig, TrainingStageConfig
    from safevla_tpu_torch.models import vit as vitmod

    vitmod.VIT_CONFIGS["probe_tiny"] = vitmod.DinoViTConfig(
        embed_dim=32, depth=1, num_heads=2, img_height=28, img_width=42,
        patch_size=14,
    )
    cfg = Config()
    cfg.model = ModelConfig(
        hidden_size=64, num_tx_layers=2, num_tx_heads=4, goal_dims=64,
        text_embed_size=64, combiner_layers=1, combiner_heads=4,
        combiner_ffn_dim=128, dino_compressor_hidden_out_dims=(64, 64),
        vision_backbone="probe_tiny", vision_feature_dim=32,
        vision_grid=(7, 12), image_size=(28, 42), max_steps=episode_steps,
        text_max_tokens=8, num_towers=3, compute_dtype="float32",
    )
    frames_per_update = streams * rollout_steps
    cfg.ppo.num_steps = rollout_steps
    cfg.ppo.lr = 3e-4  # probe-scale net; the production 2e-5 is for ViT-S towers
    cfg.ppo.entropy_coef = 0.003
    cfg.train.task_type = task_type
    cfg.train.num_train_processes = streams
    cfg.train.max_steps = episode_steps
    cfg.train.total_steps = updates * frames_per_update
    cfg.train.save_interval = 10**9  # curves only; no mid-run checkpoints
    cfg.train.tag = f"traincurve_{task_type}"
    # fresh dir per run: OnlineTrainer.init_state auto-resumes from any
    # checkpoint it finds in output_dir, which would splice two curves
    import tempfile

    cfg.train.output_dir = tempfile.mkdtemp(prefix="safevla_traincurve_")
    cfg.train.stages = [
        TrainingStageConfig(
            ["ppo_value_loss", "safe_ppo_value_loss"],
            warmup_updates * frames_per_update,
        ),
        TrainingStageConfig(["ppo_log_loss"], 10**9),
    ]
    cfg.lagrange.cost_limit = cost_limit
    return cfg


def make_probe_sampler_factory(
    cfg,
    task_type: str = "ConstrainedBandit",
    episode_max_steps: int = 16,
):
    """Per-stream samplers for the probe tasks (mirrors
    launch.make_fake_sampler_factory but with probe specs)."""
    from safevla_tpu_torch.constants import ALL_STRETCH_ACTIONS
    from safevla_tpu_torch.envs.fake_controller import FakeController
    from safevla_tpu_torch.envs.sensors import default_train_sensors
    from safevla_tpu_torch.tasks import MultiTaskSampler, TaskSpecSamplerInfiniteList

    h, w = cfg.model.image_size

    def spec(nl: str) -> dict:
        return {
            "task_type": task_type,
            "house_index": 0,
            "natural_language_spec": nl,
            "agent_starting_position": [1.5, 0.9, 3.0],
            "agent_y_rotation": 0.0,
        }

    if task_type == "InstructionBandit":
        specs = [spec("turn left"), spec("turn right")]
    else:
        specs = [spec("stay safe")]

    def factory(stream_id: int):
        controller = FakeController(seed=stream_id, image_height=h, image_width=w)
        return MultiTaskSampler(
            mode="train",
            task_args=dict(
                sensors=default_train_sensors(rgb_height=h, rgb_width=w),
                max_steps=episode_max_steps,
                action_names=ALL_STRETCH_ACTIONS,
                reward_config=None,
            ),
            houses=[{"rooms": [{}, {}]}],
            house_inds=[0],
            controller_args={"seed": stream_id, "image_height": h, "image_width": w},
            controller_type=FakeController,
            task_spec_sampler=TaskSpecSamplerInfiniteList(
                {0: specs}, shuffle=True, repeat_house_until_forced=True
            ),
            controller=controller,
        )

    return factory
