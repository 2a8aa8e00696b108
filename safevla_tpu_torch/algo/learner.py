"""The constrained-PPO learner: one update per rollout window.

Counterpart of the synchronous `update` of `safevla_tpu/algo/learner.py`:

    dual GAE (reward + cost in one loop)
    -> optional advantage normalisation
    -> lambda ascent vs cost_limit (omnisafe Lagrange semantics)
    -> cfg.ppo.update_repeats epochs of:
         full-sequence policy forward (`SafeVLAPolicy.forward_seq`)
         stage-weighted losses (PPO-Lagrangian surrogate, value, cost value;
         the HL-Gauss cross-entropy for the discrete critic)
         gradients of the tower parameters, global-norm clip + Adam (optax's)

Only the tower parameters train; the frozen ViT and T5 do not run (the batch
carries their outputs) and are in neither norm nor the optimizer (the
TrainState carries their weights for checkpoints, as the JAX one does). Where the
JAX update returns new arrays, this one updates the policy's tower
parameters and the Adam moments IN PLACE (no second copy of either): the
returned `TrainState` is the one to keep, and the one passed in must not be
updated again.

The chunk-granular decomposition of the JAX learner (the async pipeline's
`iter_chunked_update`) is ported too: the same update as many small programs
(a fusion forward per chunk of time steps -> one decoder forward and backward
-> the fusion backward per smaller chunk -> clip + Adam), as a generator
that yields after each one. The JAX package's split (one-epoch) programs have
no counterpart here: its chunked path uses only their prepare step, which is
`_prepare`, shared with `update`.

Data parallel (`mesh`, JAX `algo/learner.py`'s mesh branches): every rank
holds the replicated state (rank 0's weights and Adam moments broadcast at
`init`) and its own rows of the (B, T) window, and each reduction JAX's
sharded programs make over the global batch is a collective here: the
advantages' mean and std (count and sum, then the centred sum of squares),
the gradients (one all-reduce mean over one flat f32 buffer per apply,
before the clip: each loss is a mean over equal rank shards, so the mean of
the rank gradients is the gradient of the global loss), the last epoch's
loss metrics (all-reduced means), and the step count and chunk sizes, which
count the global B. The chunked update all-reduces once per apply, on the
stream the apply runs on; JAX's chunk programs each return replicated
gradients, whose sum is the same value.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator, NamedTuple, Optional, Tuple

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
from safevla_tpu_torch.ops.hl_gauss import HLGauss
from safevla_tpu_torch.parallel.mesh import Mesh, all_reduce_mean_, all_reduce_sum, world_size
from safevla_tpu_torch.utils.profiling import span


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


def chunk_sizes(cfg: Config, b: int, t: int) -> Tuple[int, int]:
    """(fwd_chunk_t, bwd_chunk_t): time steps per chunk program for a (b, t)
    window of b streams over every rank (JAX's chunk programs take all B,
    sharded). cfg.model.async_fusion_chunk (None: fusion_chunk; 0: the whole
    window) counts flat samples; a chunk takes all b streams x chunk_t
    steps, chunk_t the next divisor of t upward of knob / b; the backward's
    is the largest divisor of t not above half of it."""
    cfg_chunk = cfg.model.async_fusion_chunk
    if cfg_chunk is None:
        cfg_chunk = cfg.model.fusion_chunk
    n = b * t
    chunk_flat = min(cfg_chunk or n, n)
    chunk_t = max(1, min(-(-chunk_flat // b), t))
    while t % chunk_t:
        chunk_t += 1
    bwd_chunk_t = max(chunk_t // 2, 1)
    while t % bwd_chunk_t:
        bwd_chunk_t -= 1
    return chunk_t, bwd_chunk_t


class Learner:
    def __init__(self, policy: SafeVLAPolicy, cfg: Config, mesh: Optional[Mesh] = None):
        self.policy = policy
        self.cfg = cfg
        self.mesh = mesh
        self.dp = mesh.dp if mesh is not None else 1
        self.device = policy.device
        self.stage_specs = tuple(stage_spec_from_config(s, cfg.ppo) for s in cfg.train.stages)

    def init(self) -> TrainState:
        """Train state over the policy's current tower weights (the policy was
        filled from its generator, or by `load_jax_params`). On a mesh, rank
        0's tower weights and Adam moments go to every rank, and the ranks
        are checked to hold the same towers and frozen encoders."""
        self.policy.towers.requires_grad_(True)
        self.policy.vit.requires_grad_(False)
        self.policy.t5.requires_grad_(False)
        params = dict(self.policy.towers.named_parameters())
        opt_state = adam_init(list(params.values()))
        if self.mesh is not None:
            frozen = [*self.policy.vit.state_dict().values(), *self.policy.t5.state_dict().values()]
            self.mesh.replicate(list(params.values()) + opt_state.mu + opt_state.nu, frozen)
        lag = self.cfg.lagrange
        return TrainState(
            tower_params=params,
            frozen_params={"vit": self.policy.vit.state_dict(), "t5": self.policy.t5.state_dict()},
            opt_state=opt_state,
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
        """Stage-weighted losses given policy outputs -> (total, metrics),
        shared by `update` and the chunk programs of `iter_chunked_update`."""
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
        m = self.cfg.model
        if m.critic_type == "discrete":
            # HL-Gauss distributional critics train with cross-entropy on the
            # smeared return histogram (reference customized_loss.py:364-370)
            hl = HLGauss(m.hl_gauss_min, m.hl_gauss_max, m.hl_gauss_bins, m.hl_gauss_sigma)
            v_loss = 0.5 * hl.loss(out.value_logits, batch["returns"])
            cv_loss = 0.5 * hl.loss(out.c_value_logits, batch["c_returns"])
        else:
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

    def _prepare(self, train_state: TrainState, batch: Dict, mean_episode_cost, stage: StageSpec):
        """GAE -> advantages -> lambda ascent (JAX `_prepare_body`), shared by
        `update` and the chunked path: -> (the minibatch with advantages and
        returns, the new Lagrange state, the multiplier)."""
        with span("step.prepare"):
            ppo = self.cfg.ppo
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
                # the mean and std (ddof 0, jnp's) over the global batch, in jnp's
                # two passes: every rank holds as many rows (each dp shard on mdl
                # ranks), so the global count is this rank's times the world size
                keys = ("advantages", "c_advantages")
                n = mb[keys[0]].numel() * world_size(self.mesh)
                mean = all_reduce_sum(self.mesh, torch.stack([mb[k].sum() for k in keys])) / n
                sq = torch.stack([((mb[k] - mean[i]) ** 2).sum() for i, k in enumerate(keys)])
                std = torch.sqrt(all_reduce_sum(self.mesh, sq) / n)
                for i, k in enumerate(keys):
                    mb[k] = (mb[k] - mean[i]) / (std[i] + 1e-8)

            # 2. lambda ascent (only in stages with the Lagrangian loss)
            lagrange = train_state.lagrange
            if stage.use_lagrange:
                lagrange = update_lagrange(lagrange, mean_episode_cost, self.cfg.lagrange.multiplier_lr)
            return mb, lagrange, multiplier_value(lagrange)

    def _finish(self, train_state, opt_state, lagrange, metrics, lam, mean_episode_cost, b, t):
        """The returned state and the last epoch's metrics (0-d tensors); `b`
        is the global stream count. The loss metrics are their means over
        the ranks (the norms are global already)."""
        metrics = {k: v.detach() for k, v in metrics.items()}
        keys = [k for k in metrics if k not in ("grad_norm", "weight_norm")]
        vals = all_reduce_sum(self.mesh, torch.stack([metrics[k].float() for k in keys]))
        metrics.update(zip(keys, vals / world_size(self.mesh)))
        metrics["lagrange_multiplier"] = lam
        metrics["mean_episode_cost"] = torch.as_tensor(
            mean_episode_cost, dtype=torch.float32, device=self.device
        )
        new_state = TrainState(
            tower_params=train_state.tower_params,
            frozen_params=train_state.frozen_params,
            opt_state=opt_state,
            lagrange=lagrange,
            step=train_state.step + b * t,
        )
        return new_state, metrics

    def _apply(self, params, grads, opt_state, metrics) -> AdamState:
        """Global-norm clip and one Adam step of `params` in place; the norms
        go into `metrics`. On a mesh the gradients are first replaced by
        their mean over the ranks (one collective, on the current stream)."""
        with span("step.optimizer"):
            with torch.no_grad():
                all_reduce_mean_(self.mesh, grads)
                clipped, metrics["grad_norm"] = clip_by_global_norm(grads, self.cfg.ppo.max_grad_norm)
                metrics["weight_norm"] = global_norm(params)
            return adam_step(params, clipped, opt_state, self.cfg.ppo.lr)

    def update(
        self, train_state: TrainState, batch: Dict, mean_episode_cost, stage_id: int
    ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        """One rollout's worth of learning. `batch` holds (B, T, ...) arrays
        or tensors (values, c_values, masks (B, T+1)); they are moved to the
        policy's device. Metrics (0-d tensors on that device) are the last
        epoch's. The update is the span `step`; its parts `step.prepare`,
        `step.forward`, `step.backward` and `step.optimizer`."""
        with span("step"):
            stage = self.stage_specs[min(int(stage_id), len(self.stage_specs) - 1)]
            batch = {k: torch.as_tensor(v, device=self.device) for k, v in batch.items()}
            mb, lagrange, lam = self._prepare(train_state, batch, mean_episode_cost, stage)

            # 3. PPO epochs
            params = list(train_state.tower_params.values())
            opt_state = train_state.opt_state
            for _ in range(self.cfg.ppo.update_repeats):
                with span("step.forward"):
                    total, metrics = self._loss_fn(mb, lam, stage)
                with span("step.backward"):
                    grads = torch.autograd.grad(total, params, allow_unused=True)
                    # optax steps every leaf: a parameter the loss did not reach gets 0
                    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]
                opt_state = self._apply(params, grads, opt_state, metrics)
            b, t = batch["rewards"].shape
            b *= self.dp
            return self._finish(train_state, opt_state, lagrange, metrics, lam, mean_episode_cost, b, t)

    # ------------------------------------------------------------------
    # chunk-granular update: the async pipeline pumps these programs one at
    # a time between the rollout's acts
    # ------------------------------------------------------------------
    def chunk_sizes(self, b: int, t: int) -> Tuple[int, int]:
        return chunk_sizes(self.cfg, b, t)

    def chunked_program_count(self, b: int, t: int) -> int:
        """Programs `iter_chunked_update` yields for a (b, t) window (b: every
        rank's streams); the async trainer pumps ceil(count / T) of them per env step."""
        chunk_t, bwd_chunk_t = self.chunk_sizes(b, t)
        return 1 + self.cfg.ppo.update_repeats * (t // chunk_t + t // bwd_chunk_t + 2)

    def _embed(self, mb, start_t: int, chunk_t: int) -> torch.Tensor:
        return self.policy.embed_time_range(
            mb["dino_nav"], mb.get("dino_manip"), mb["text_hidden"], mb["text_mask"],
            mb.get("text_idx"), start_t, chunk_t,
        )

    def iter_chunked_update(
        self, train_state: TrainState, batch: Dict, mean_episode_cost, stage_id: int
    ) -> Iterator[None]:
        """Generator form of `update` (JAX `iter_chunked_update`): yields once
        after each program, `chunked_program_count(B, T)` times, and returns
        (new TrainState, metrics) through StopIteration.value. Its programs
        (JAX `_make_chunked_fns`):
          prepare     GAE, advantages, the lambda ascent (`_prepare`);
          per epoch:
          embed_chunk      the fusion forward (no gradient) of chunk_t steps
                           of every stream into the (towers, B, T, D) f32
                           embedding buffer;
          decoder_grad     decoder and heads over the buffer, a leaf: the
                           loss, its gradients in the decoder and head weights
                           and in the buffer (d_obs);
          fusion_bwd_chunk the fusion forward of bwd_chunk_t steps again, with
                           a gradient, back-propagated against d_obs's slice;
                           the weights' gradients added into g_acc in order;
          apply            g_acc + the decoder's gradients, clip, Adam (in
                           place, as `update`).
        The tower weights change in place at each apply: the caller acts
        with another copy of them while this runs (`acting_copy`)."""
        stage = self.stage_specs[min(int(stage_id), len(self.stage_specs) - 1)]
        batch = {k: torch.as_tensor(v, device=self.device) for k, v in batch.items()}
        b, t = batch["prev_actions"].shape  # this rank's streams
        chunk_t, bwd_chunk_t = self.chunk_sizes(b * self.dp, t)
        mb, lagrange, lam = self._prepare(train_state, batch, mean_episode_cost, stage)
        yield
        params = list(train_state.tower_params.values())
        opt_state = train_state.opt_state
        shape = (self.policy.num_towers, b, t, self.cfg.model.hidden_size)
        metrics = None
        for _ in range(self.cfg.ppo.update_repeats):
            obs_buf = torch.zeros(shape, dtype=torch.float32, device=self.device)
            for c in range(0, t, chunk_t):
                with torch.no_grad():
                    obs_buf[:, :, c : c + chunk_t] = self._embed(mb, c, chunk_t)
                yield
            obs_buf.requires_grad_(True)
            out = self.policy.decode_from_embeds(
                obs_buf, mb["prev_actions"], mb["not_reset"], mb.get("object_in_hand"),
                mb["time_step"], mb["traj_idx"],
            )
            total, metrics = self._loss_from_outputs(out, mb, lam, stage)
            *g_dec, d_obs = torch.autograd.grad(total, params + [obs_buf], allow_unused=True)
            g_dec = [torch.zeros_like(p) if g is None else g for p, g in zip(params, g_dec)]
            metrics = {k: v.detach() for k, v in metrics.items()}
            del out, total  # the generator's frame would hold the graph across the yield
            yield
            g_acc = [torch.zeros_like(p) for p in params]
            for c in range(0, t, bwd_chunk_t):
                emb = self._embed(mb, c, bwd_chunk_t)
                grads = torch.autograd.grad(emb, params, d_obs[:, :, c : c + bwd_chunk_t], allow_unused=True)
                with torch.no_grad():
                    for acc, g in zip(g_acc, grads):
                        if g is not None:
                            acc.add_(g)
                del emb, grads
                yield
            with torch.no_grad():
                grads = [f + d for f, d in zip(g_acc, g_dec)]
            opt_state = self._apply(params, grads, opt_state, metrics)
            del obs_buf, d_obs, g_dec, g_acc, grads
            yield
        return self._finish(train_state, opt_state, lagrange, metrics, lam, mean_episode_cost, b * self.dp, t)

    def chunked_update(self, train_state: TrainState, batch: Dict, mean_episode_cost, stage_id: int):
        """`iter_chunked_update` drained at once: the synchronous entry point
        (the tests hold it to `update` and to JAX's chunked_update)."""
        it = self.iter_chunked_update(train_state, batch, mean_episode_cost, stage_id)
        while True:
            try:
                next(it)
            except StopIteration as stop:
                return stop.value

    def stage_for_step(self, step: int) -> int:
        acc = 0
        for i, st in enumerate(self.cfg.train.stages):
            acc += st.max_stage_steps
            if step < acc:
                return i
        return len(self.cfg.train.stages) - 1
