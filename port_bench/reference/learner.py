"""Plain PyTorch PPO-Lagrangian update, in float32: SafeVLA's learner step.

    reward and cost GAE (gamma, lambda; masks cut the return at episode starts)
    -> the Lagrange multiplier's ascent (omnisafe: Adam on -lambda (Jc - limit),
       then projected to lambda >= 0), used in this update's loss
    -> `epochs` passes of: the three towers' full-sequence forward (the actor
       from tower 0, the reward critic from tower 1, the cost critic from
       tower 2); the clipped surrogate on (A - lambda A_c) / (1 + lambda),
       plus value_coef x 0.5 MSE of each critic; its gradient; the clip to a
       global norm; one Adam step (optax's: one count, every leaf stepped,
       bias corrections computed in f32).

The fusion of every step runs in blocks of rows: its embeddings without a
graph, then the loss over the whole window against those embeddings as
leaves, then each block again with a graph, back-propagated against the
embeddings' gradient. That is the gradient of the one loss over the window;
the blocks only keep the activations of the 3 x 4096 steps out of memory.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import numpy as np
import torch

from port_bench.reference.tower import F32, Numerics, Tower, fusion_params, split_towers


@dataclass
class Adam:
    count: int
    mu: Dict[str, torch.Tensor]
    nu: Dict[str, torch.Tensor]


def adam_init(params: Dict[str, torch.Tensor]) -> Adam:
    return Adam(0, {k: torch.zeros_like(v) for k, v in params.items()}, {k: torch.zeros_like(v) for k, v in params.items()})


@torch.no_grad()
def adam_step(params, grads, st: Adam, lr: float, weight_decay: float = 0.0, b1=0.9, b2=0.999, eps=1e-8) -> Adam:
    """optax.adam / optax.adamw(weight_decay): every leaf, one count."""
    count = st.count + 1
    bc1 = float(1 - np.float32(b1) ** np.float32(count))
    bc2 = float(1 - np.float32(b2) ** np.float32(count))
    for k, p in params.items():
        g = grads[k]
        st.mu[k].mul_(b1).add_(g, alpha=1 - b1)
        st.nu[k].mul_(b2).add_(g * g, alpha=1 - b2)
        u = (st.mu[k] / bc1) / (torch.sqrt(st.nu[k] / bc2) + eps)
        if weight_decay:
            u = u + weight_decay * p
        p.add_(-lr * u)
    return Adam(count, st.mu, st.nu)


def gae(rewards, values, masks, gamma: float, lam: float):
    """rewards (B, T), values (B, T+1), masks (B, T+1) -> (advantages, returns) (B, T)."""
    t = rewards.shape[1]
    nxt = masks[:, 1:]
    delta = rewards + gamma * values[:, 1:] * nxt - values[:, :-1]
    adv = torch.zeros_like(rewards)
    run = torch.zeros_like(rewards[:, 0])
    for i in range(t - 1, -1, -1):
        run = delta[:, i] + gamma * lam * nxt[:, i] * run
        adv[:, i] = run
    return adv, adv + values[:, :-1]


@dataclass
class Lagrange:
    value: torch.Tensor
    opt: Adam


def lagrange_init(init: float, device) -> Lagrange:
    v = torch.tensor(max(init, 0.0), dtype=torch.float32, device=device)
    return Lagrange(v, adam_init({"m": v}))


def lagrange_step(st: Lagrange, mean_episode_cost: float, limit: float, lr: float) -> Lagrange:
    v = st.value.clone()
    opt = Adam(st.opt.count, {"m": st.opt.mu["m"].clone()}, {"m": st.opt.nu["m"].clone()})
    grad = -(torch.tensor(mean_episode_cost, dtype=torch.float32, device=v.device) - limit)
    opt = adam_step({"m": v}, {"m": grad}, opt, lr)
    return Lagrange(torch.clamp(v, min=0.0), opt)


def blocked_grads(params, m, nm, towers, t, step, embed, loss_of):
    """The loss over a (B, T) window and its gradient in every leaf (zeros
    where it does not reach), the fusion run in blocks of `step` time steps:
    embed(tower, t0, t1) -> (B, t1 - t0, D); loss_of(towers, [(B, T, D)
    per tower]) -> the scalar loss."""
    names = list(params)
    fus = set(fusion_params(names))
    for p in params.values():
        p.requires_grad_(True)
    try:
        tws = [Tower(w, m, nm) for w in split_towers(params, towers)]
        with torch.no_grad():
            obs = [torch.cat([embed(tw, c, c + step) for c in range(0, t, step)], 1) for tw in tws]
        obs = [o.requires_grad_(True) for o in obs]
        total = loss_of(tws, obs)
        rest = [n for n in names if n not in fus]
        got = torch.autograd.grad(total, [params[n] for n in rest] + obs, allow_unused=True)
        grads = {n: (g if g is not None else torch.zeros_like(params[n])) for n, g in zip(rest, got)}
        grads.update({n: torch.zeros_like(params[n]) for n in fus})
        d_obs = got[len(rest):]
        for ti, tw in enumerate(tws):
            tn = [n for n in fus if n.startswith(f"{ti}.")]
            for c in range(0, t, step):
                gs = torch.autograd.grad(embed(tw, c, c + step), [params[n] for n in tn],
                                         d_obs[ti][:, c : c + step], allow_unused=True)
                for n, g in zip(tn, gs):
                    if g is not None:
                        grads[n] += g
    finally:
        for p in params.values():
            p.requires_grad_(False)
    return total.detach(), grads


class Learner:
    """The reference learner over the towers' f32 weights {"<t>.<name>": w}."""

    def __init__(self, weights: Dict[str, torch.Tensor], m: dict, ppo: dict, lagrange: dict,
                 nm: Numerics = F32, block: int = 512):
        self.params = {k: v.clone() for k, v in weights.items()}
        self.m, self.ppo, self.lag_cfg, self.nm, self.block = m, ppo, lagrange, nm, block
        self.towers = 3
        self.opt = adam_init(self.params)
        self.lag = lagrange_init(lagrange["multiplier_init"], next(iter(weights.values())).device)

    def _text(self, batch, t0: int, t1: int):
        """Each step's instruction (B*(t1-t0), L, D) from the (B, E, L, D) table."""
        rows = torch.arange(batch["text_idx"].shape[0], device=batch["text_idx"].device)[:, None]
        idx = batch["text_idx"][:, t0:t1].long()
        th, tm = batch["text_hidden"][rows, idx], batch["text_mask"][rows, idx]
        return th.reshape((-1,) + th.shape[2:]), tm.reshape(-1, tm.shape[-1])

    def _embed(self, tower: Tower, batch, t0: int, t1: int):
        b = batch["dino_nav"].shape[0]
        fl = lambda x: x[:, t0:t1].reshape((-1,) + x.shape[2:])
        th, tm = self._text(batch, t0, t1)
        return tower.embed(fl(batch["dino_nav"]), fl(batch["dino_manip"]), th, tm).reshape(b, t1 - t0, -1)

    def _steps_per_block(self, b: int, t: int) -> int:
        n = max(1, self.block // b)
        while t % n:
            n -= 1
        return n

    def loss(self, outs, mb, lam):
        """outs: per tower (logits, values) -> the stage's total loss."""
        ppo = self.ppo
        logits, values, c_values = outs[0][0], outs[1][1], outs[2][1]
        adv = (mb["advantages"] - lam * mb["c_advantages"]) / (1.0 + lam)
        logp = torch.log_softmax(logits, dim=-1).gather(-1, mb["actions"].long()[..., None])[..., 0]
        ratio = torch.exp(logp - mb["old_log_probs"])
        clipped = torch.clamp(ratio, 1.0 - ppo["clip_param"], 1.0 + ppo["clip_param"])
        action = (-torch.minimum(ratio * adv, clipped * adv)).mean()
        v = 0.5 * ((mb["returns"] - values) ** 2).mean()
        cv = 0.5 * ((mb["c_returns"] - c_values) ** 2).mean()
        return action + ppo["value_loss_coef"] * v + ppo["value_loss_coef"] * cv

    def update(self, batch: Dict[str, torch.Tensor], mean_episode_cost: float):
        """One update over a (B, T) window -> the last epoch's loss (float)."""
        ppo = self.ppo
        adv, ret = gae(batch["rewards"], batch["values"], batch["masks"], ppo["gamma"], ppo["gae_lambda"])
        cadv, cret = gae(batch["costs"], batch["c_values"], batch["masks"], ppo["gamma"], ppo["gae_lambda"])
        mb = dict(batch, advantages=adv, c_advantages=cadv, returns=ret, c_returns=cret)
        self.lag = lagrange_step(self.lag, mean_episode_cost, self.lag_cfg["cost_limit"], self.lag_cfg["multiplier_lr"])
        lam = self.lag.value
        b, t = batch["rewards"].shape
        step = self._steps_per_block(b, t)
        loss = None
        for _ in range(ppo["update_repeats"]):
            total, grads = blocked_grads(
                self.params, self.m, self.nm, self.towers, t, step,
                lambda tw, c0, c1: self._embed(tw, batch, c0, c1),
                lambda towers, obs: self.loss(
                    [tw.decode(o, batch["prev_actions"], batch["not_reset"], batch["object_in_hand"],
                               batch["time_step"], batch["traj_idx"]) for tw, o in zip(towers, obs)], mb, lam),
            )
            loss = float(total)
            with torch.no_grad():
                norm = torch.sqrt(sum((g * g).sum() for g in grads.values()))
                scale = torch.where(norm < ppo["max_grad_norm"], torch.ones_like(norm), ppo["max_grad_norm"] / norm)
                grads = {k: g * scale for k, g in grads.items()}
            self.opt = adam_step(self.params, grads, self.opt, ppo["lr"])
        return loss

