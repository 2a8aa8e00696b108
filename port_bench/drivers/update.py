"""Driver of the PPO-Lagrangian update: `Learner.update`, the sync trainer's
update, closed loop, one update of a (streams x steps) rollout window after
another, the train state carried from update to update.

Traffic (traffic/<name>.json): each window is made on the card from the seed
in the shape of the sync trainer's: frozen-encoder features (normal), two
episodes a stream with a boundary at a step of its own, an instruction
table of two encodings a stream with right-padded masks, random actions,
rewards (normal) and integer costs in [0, cost_levels). Boundaries, episode
starts and instruction lengths are the same sets for every seed, dealt to
the streams in the seed's order. `pool` distinct windows are made in
set-up; the compared steps take the first ones and the timed window cycles
through them.
"""

from __future__ import annotations

import math
import time

import torch

from port_bench.harness import synchronize
from port_bench.program import program_config, strict_load
from port_bench.reference import flops as FL
from port_bench.reference import params as P

WEIGHTS, TRAFFIC = 1, 100  # generator streams of a run's seed
TOWERS = 3


def make_window(tr: dict, m: dict, seed: int, index: int, device) -> dict:
    g = torch.Generator(device=device).manual_seed(P.stream_seed(seed, TRAFFIC + index))
    b, t, e = tr["streams"], tr["steps"], tr["episodes_per_stream"]
    gh, gw = m["vision_grid"]
    dv, dt, length, a = m["vision_feature_dim"], m["text_embed_size"], m["text_max_tokens"], m["num_actions"]
    randn = lambda *s: torch.randn(s, generator=g, device=device)
    randint = lambda hi, *s: torch.randint(0, hi, s, generator=g, device=device, dtype=torch.int32)

    def dealt(values):
        v = torch.as_tensor(values, device=device)
        return v[torch.randperm(len(values), generator=g, device=device)]

    boundary = dealt(P.spread(1, t - 1, b))
    start = dealt(P.spread(0, tr["episode_start_max"], b))
    lengths = tr["text_lengths"]
    lengths = dealt([lengths[i % len(lengths)] for i in range(b * e)]).reshape(b, e)
    steps = torch.arange(t, device=device)[None]
    traj = (steps >= boundary[:, None]).to(torch.int32)
    not_reset = (steps != boundary[:, None]).to(torch.int32)
    time_step = torch.where(traj == 0, start[:, None] + steps, steps - boundary[:, None]).to(torch.int32)
    masks = torch.ones(b, t + 1, device=device)
    masks[:, :t] = not_reset
    return {
        "dino_nav": randn(b, t, gh, gw, dv),
        "dino_manip": randn(b, t, gh, gw, dv),
        "text_hidden": randn(b, e, length, dt),
        "text_mask": torch.arange(length, device=device)[None, None] < lengths[..., None],
        "text_idx": traj,
        "prev_actions": randint(a, b, t),
        "not_reset": not_reset,
        "object_in_hand": randint(3, b, t),
        "time_step": time_step,
        "traj_idx": traj,
        "actions": randint(a, b, t),
        "old_log_probs": math.log(1.0 / a) + tr["old_log_prob_noise"] * randn(b, t),
        "rewards": randn(b, t),
        "costs": randint(tr["cost_levels"], b, t).float(),
        "values": randn(b, t + 1),
        "c_values": randn(b, t + 1),
        "masks": masks,
    }


def half_batch(batch: dict) -> dict:
    """The fault "half of the batch left out": the first half of the streams."""
    b = batch["rewards"].shape[0]
    return {k: v[: b // 2] for k, v in batch.items()}


class Driver:
    def __init__(self, spec, seed: int, device):
        self.spec, self.seed, self.device = spec, seed, torch.device(device)
        self.tr, self.cfg_file = spec.traffic, spec.config
        self.m = self.cfg_file["model"]
        self.param_spec = P.towers_spec(self.m, TOWERS)
        self.compared = None
        self._out = []

    def weights(self):
        return P.make_weights(self.param_spec, self.seed, WEIGHTS, self.device)

    def windows(self):
        return [make_window(self.tr, self.m, self.seed, i, self.device) for i in range(self.tr["pool"])]

    def _update(self, i: int):
        self.ts, metrics = self.learner.update(
            self.ts, self.batches[i % len(self.batches)], self.tr["mean_episode_cost"], self.tr["stage"]
        )
        return metrics["total"]

    def setup(self) -> None:
        from safevla_tpu_torch.algo.learner import Learner
        from safevla_tpu_torch.models.actor_critic import SafeVLAPolicy

        cfg = program_config(self.cfg_file, TOWERS)
        policy = SafeVLAPolicy(cfg.model, device=self.device)
        w0 = self.weights()
        strict_load(policy.towers, P.served(w0, self.param_spec))
        self.learner = Learner(policy, cfg)
        self.ts = self.learner.init()
        self.batches = self.windows()
        self.facts = self._facts()
        losses, grad = [], None
        for i in range(self.tr["compared_steps"]):
            losses.append(float(self._update(i)))
            if i == 0:
                grad = {k: float(mu.norm()) for k, mu in zip(self.ts.tower_params, self.ts.opt_state.mu)}
        change = {k: float((p.detach() - w0[k]).norm()) for k, p in self.ts.tower_params.items()}
        self.compared = {"loss": losses, "grad": grad, "change": change}
        self.next = self.tr["compared_steps"]

    def _facts(self) -> dict:
        """The work one update needs: its operations without recompute, and
        the attention calls of the fusion layers that run the kernel."""
        m, b, t = self.m, self.tr["streams"], self.tr["steps"]
        epochs = self.cfg_file["ppo"]["update_repeats"]
        gh, gw = m["vision_grid"]
        prefix = 1 + 2 * gh * gw
        s = -(-(prefix + m["text_max_tokens"]) // 16) * 16
        valid = 0.0
        for w in self.batches:
            rows = torch.arange(b, device=self.device)[:, None]
            text_len = w["text_mask"].sum(-1)[rows, w["text_idx"].long()]
            valid += float((prefix + text_len).sum()) / len(self.batches)
        call = {"b": b * t, "s": s, "heads": m["fusion_heads"], "dh": m["hidden_size"] // m["fusion_heads"],
                "valid": valid, "calls": TOWERS * epochs * (m["fusion_layers"] - 1)}
        return {
            "flops_per_step": FL.update_flops(m, TOWERS, epochs, b, t),
            "samples_per_step": b * t,
            "attention_fwd": [call],
            "attention_bwd": [call],
        }

    def window(self, seconds: float) -> dict:
        synchronize(self.device)
        t0 = time.perf_counter()
        steps = 0
        while time.perf_counter() - t0 < seconds:
            self._out.append(self._update(self.next))
            self.next += 1
            steps += 1
        synchronize(self.device)
        t1 = time.perf_counter()
        return {"t0": t0, "t1": t1, "steps": steps, "data_wait_s": [], "facts": self.facts}

    def outcomes(self):
        return [math.isfinite(float(x)) for x in self._out]

    def free(self) -> None:
        self.learner = self.ts = self.batches = None
        self._out = []

    def reference(self, numerics=None, half: bool = False) -> dict:
        """The plain reference over the compared steps, from the seed's weights
        and windows (made again here); `half` runs the half-batch fault."""
        from port_bench.reference.learner import Learner
        from port_bench.reference.tower import F32

        w0 = self.weights()
        batches = self.windows()
        if half:
            batches = [half_batch(w) for w in batches]
        ref = Learner(w0, self.m, self.cfg_file["ppo"], self.cfg_file["lagrange"], numerics or F32)
        losses, grad = [], None
        for i in range(self.tr["compared_steps"]):
            losses.append(ref.update(batches[i % len(batches)], self.tr["mean_episode_cost"]))
            if i == 0:
                grad = {k: float(v.norm()) for k, v in ref.opt.mu.items()}
        change = {k: float((ref.params[k] - w0[k]).norm()) for k in w0}
        return {"loss": losses, "grad": grad, "change": change}
