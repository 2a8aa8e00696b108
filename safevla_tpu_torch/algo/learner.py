"""The constrained-PPO learner: one update per rollout window.

Counterpart of the synchronous `update` of `safevla_tpu/algo/learner.py`:

    dual GAE (reward + cost in one loop)
    -> optional advantage normalisation
    -> lambda ascent vs cost_limit (omnisafe Lagrange semantics)
    -> cfg.ppo.update_repeats epochs of:
         full-sequence policy forward (`SafeVLAPolicy.forward_seq`)
         stage-weighted losses (PPO-Lagrangian surrogate, value, cost value)
         gradients of the tower parameters, global-norm clip + Adam (optax's)

Only the tower parameters train; the frozen ViT and T5 do not run (the batch
carries their outputs) and are in neither norm nor the optimizer (the
TrainState carries their weights for checkpoints, as the JAX one does). Where the
JAX update returns new arrays, this one updates the policy's tower
parameters and the Adam moments IN PLACE (no second copy of either): the
returned `TrainState` is the one to keep, and the one passed in must not be
updated again. The split and chunked decompositions of the JAX learner (the
async pipeline) are not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, NamedTuple, Tuple

import torch

from safevla_tpu_torch.algo import losses as L
from safevla_tpu_torch.algo.lagrange import (
    LagrangeState,
    init_lagrange,
    multiplier_value,
    update_lagrange,
)
from safevla_tpu_torch.algo.optim import AdamState, adam_init, adam_step, clip_by_global_norm, global_norm
from safevla_tpu_torch.config import Config
from safevla_tpu_torch.models.actor_critic import SafeVLAPolicy
from safevla_tpu_torch.ops.gae import dual_gae


@dataclass
class TrainState:
    tower_params: Dict[str, torch.nn.Parameter]  # the policy's tower parameters (live)
    # {"vit": ..., "t5": ...}: the frozen encoders' state dicts (live), saved
    # with the towers so that a restored policy runs the backbone it trained with
    frozen_params: Dict[str, Dict[str, torch.Tensor]]
    opt_state: AdamState
    lagrange: LagrangeState
    step: int  # env steps consumed so far


class StageSpec(NamedTuple):
    """Static loss weights for one pipeline stage (resolved from the named
    losses in cfg.train.stages, reference PipelineStage loss_names)."""

    action_weight: float
    value_weight: float
    c_value_weight: float
    imitation_weight: float
    use_lagrange: bool


def stage_spec_from_config(stage_cfg, ppo) -> StageSpec:
    """Resolve a TrainingStageConfig's named losses into static weights.

    The PPO policy losses bundle their value terms at ppo.value_loss_coef
    (reference SafePPOLogGrad, customized_loss.py:364-383); standalone value
    losses add at their own weight (the critic-warmup stage trains them at 1)."""
    names = list(stage_cfg.loss_names)
    weights = list(stage_cfg.loss_weights or [1.0] * len(names))
    if len(weights) != len(names):
        raise ValueError(f"loss_weights ({len(weights)}) must match loss_names ({len(names)})")
    action = value = c_value = imitation = 0.0
    use_lagrange = False
    for name, w in zip(names, weights):
        if name == "ppo_log_loss":  # PPO-Lagrangian surrogate
            action += w
            value += w * ppo.value_loss_coef
            c_value += w * ppo.value_loss_coef
            use_lagrange = True
        elif name == "ppo_loss":  # unconstrained PPO: no cost-value term
            action += w
            value += w * ppo.value_loss_coef
        elif name == "ppo_value_loss":
            value += w
        elif name == "safe_ppo_value_loss":
            c_value += w
        elif name == "imitation_bce_loss":
            imitation += w
        else:
            raise ValueError(f"Unknown loss name in pipeline stage: {name!r}")
    return StageSpec(action, value, c_value, imitation, use_lagrange)


class Learner:
    def __init__(self, policy: SafeVLAPolicy, cfg: Config):
        self.policy = policy
        self.cfg = cfg
        self.device = policy.device
        self.stage_specs = tuple(stage_spec_from_config(s, cfg.ppo) for s in cfg.train.stages)

    def init(self) -> TrainState:
        """Train state over the policy's current tower weights (the policy was
        filled from its generator, or by `load_jax_params`)."""
        self.policy.towers.requires_grad_(True)
        self.policy.vit.requires_grad_(False)
        self.policy.t5.requires_grad_(False)
        params = dict(self.policy.towers.named_parameters())
        lag = self.cfg.lagrange
        return TrainState(
            tower_params=params,
            frozen_params={"vit": self.policy.vit.state_dict(), "t5": self.policy.t5.state_dict()},
            opt_state=adam_init(list(params.values())),
            lagrange=init_lagrange(
                lag.cost_limit, lag.multiplier_init, lag.multiplier_lr,
                lag.multiplier_upper_bound, device=self.device,
            ),
            step=0,
        )

    def _forward(self, batch):
        return self.policy.forward_seq(
            batch["dino_nav"],
            batch.get("dino_manip"),
            batch["text_hidden"],
            batch["text_mask"],
            batch["prev_actions"],
            batch["not_reset"],
            batch.get("object_in_hand"),
            batch["time_step"],
            batch["traj_idx"],
            batch.get("text_idx"),
        )

    def _loss_fn(self, batch, lam, stage: StageSpec):
        return self._loss_from_outputs(self._forward(batch), batch, lam, stage)

    def _loss_from_outputs(self, out, batch, lam, stage: StageSpec):
        """Stage-weighted losses given policy outputs -> (total, metrics).
        Only the linear critic is ported, so the values train by MSE."""
        ppo = self.cfg.ppo
        metrics = {}
        adv = batch["advantages"]
        if stage.use_lagrange:
            adv = (adv - lam * batch["c_advantages"]) / (1.0 + lam)
        log_probs = L.categorical_log_prob(out.logits, batch["actions"])
        action_loss = L.clipped_surrogate(
            log_probs, batch["old_log_probs"], adv, ppo.clip_param
        ).mean()
        entropy = L.categorical_entropy(out.logits).mean()
        v_loss = L.value_loss(
            out.values, batch["returns"], batch["old_values"], ppo.clip_param,
            ppo.use_clipped_value_loss,
        )
        cv_loss = L.value_loss(
            out.c_values, batch["c_returns"], batch["old_c_values"], ppo.clip_param,
            ppo.use_clipped_value_loss,
        )
        total = (
            stage.action_weight * action_loss
            + stage.value_weight * v_loss
            + stage.c_value_weight * cv_loss
            - stage.action_weight * ppo.entropy_coef * entropy
        )
        if stage.imitation_weight:
            # expert-pickupable BCE aux loss (reference customized_loss.py:17-83)
            if "expert_pickupable" not in batch:
                raise KeyError(
                    "imitation_bce_loss is enabled for this stage but the batch has no "
                    "'expert_pickupable' signal — add ExpertPickupableSensor to the sensor suite"
                )
            imitation = L.imitation_bce_loss(out.logits, batch["expert_pickupable"].float())
            total = total + stage.imitation_weight * imitation
            metrics["imitation"] = imitation
        metrics.update(
            action=action_loss,
            value=v_loss,
            c_value=cv_loss,
            entropy=entropy,
            total=total,
            approx_kl=(batch["old_log_probs"] - log_probs).mean(),
        )
        return total, metrics

    def update(
        self, train_state: TrainState, batch: Dict, mean_episode_cost, stage_id: int
    ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        """One rollout's worth of learning. `batch` holds (B, T, ...) arrays
        or tensors (values, c_values, masks (B, T+1)); they are moved to the
        policy's device. Metrics (0-d tensors on that device) are the last
        epoch's."""
        stage = self.stage_specs[min(int(stage_id), len(self.stage_specs) - 1)]
        ppo = self.cfg.ppo
        batch = {k: torch.as_tensor(v, device=self.device) for k, v in batch.items()}

        # 1. fused reward + cost GAE over the (T, B) layout
        rewards = torch.stack([batch["rewards"].T.float(), batch["costs"].T.float()])
        values = torch.stack([batch["values"].T.float(), batch["c_values"].T.float()])
        adv, ret = dual_gae(rewards, values, batch["masks"].T, ppo.gamma, ppo.gae_lambda)
        mb = dict(batch)
        mb["advantages"] = adv[0].T
        mb["c_advantages"] = adv[1].T
        mb["returns"] = ret[0].T
        mb["c_returns"] = ret[1].T
        mb["old_values"] = batch["values"][:, :-1]
        mb["old_c_values"] = batch["c_values"][:, :-1]
        if ppo.normalize_advantage:
            for k in ("advantages", "c_advantages"):
                a = mb[k]
                mb[k] = (a - a.mean()) / (a.std(correction=0) + 1e-8)  # jnp's std: ddof 0

        # 2. lambda ascent (only in stages with the Lagrangian loss)
        lagrange = train_state.lagrange
        if stage.use_lagrange:
            lagrange = update_lagrange(lagrange, mean_episode_cost, self.cfg.lagrange.multiplier_lr)
        lam = multiplier_value(lagrange)

        # 3. PPO epochs
        params = list(train_state.tower_params.values())
        opt_state = train_state.opt_state
        for _ in range(ppo.update_repeats):
            total, metrics = self._loss_fn(mb, lam, stage)
            grads = torch.autograd.grad(total, params, allow_unused=True)
            # optax steps every leaf: a parameter the loss did not reach gets 0
            grads = [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]
            with torch.no_grad():
                clipped, metrics["grad_norm"] = clip_by_global_norm(grads, ppo.max_grad_norm)
                metrics["weight_norm"] = global_norm(params)
            opt_state = adam_step(params, clipped, opt_state, ppo.lr)
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics["lagrange_multiplier"] = lam
        metrics["mean_episode_cost"] = torch.as_tensor(
            mean_episode_cost, dtype=torch.float32, device=self.device
        )
        b, t = batch["rewards"].shape
        new_state = TrainState(
            tower_params=train_state.tower_params,
            frozen_params=train_state.frozen_params,
            opt_state=opt_state,
            lagrange=lagrange,
            step=train_state.step + b * t,
        )
        return new_state, metrics

    def stage_for_step(self, step: int) -> int:
        acc = 0
        for i, st in enumerate(self.cfg.train.stages):
            acc += st.max_stage_steps
            if step < acc:
                return i
        return len(self.cfg.train.stages) - 1
