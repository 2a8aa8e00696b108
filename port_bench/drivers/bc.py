"""Driver of behaviour cloning: the loop inside `OfflineTrainer.fit`,
`prepared_batches` -> `attach_text` -> `_bc_step`, closed loop, one tower.

Traffic (traffic/<name>.json): host batches in the offline phase's format
(uint8 frames of both cameras at the configuration's image size, previous
actions, targets with -1 past each row's valid steps, in-episode step ids,
object-in-hand flags, one instruction a row), made on the card from the
seed and copied to host memory once; `pool` distinct batches, the compared
steps on the first ones, the timed window cycling through them. Valid
lengths, episode starts and instructions are the same sets for every seed,
dealt to the rows in the seed's order. One augmentation is drawn from the
seed as the configuration's v2 sampler draws it (an epoch's).
"""

from __future__ import annotations

import itertools
import math
import time

import numpy as np
import torch

from port_bench.harness import synchronize
from port_bench.program import program_config, strict_load
from port_bench.reference import flops as FL
from port_bench.reference import params as P
from port_bench.reference.vision import tokenize

TOWER_W, VIT_W, TEXT_W, AUG, TRAFFIC = 1, 2, 3, 99, 100  # generator streams of a run's seed


def draw_augment(tr: dict, seed: int) -> dict:
    """One transform, as SPOC's v2 `sample_a_specific_transform` draws it:
    jitter factors uniform in torchvision's ranges, blur sigma, crop area,
    four posterize gates (the fewest bits applied wins), a sharpness coin."""
    a = tr["augmentation"]
    g = torch.Generator().manual_seed(P.stream_seed(seed, AUG))
    rand = lambda n=(): torch.rand(n, generator=g, dtype=torch.float32)
    u = lambda lo, hi: float(lo + (hi - lo) * rand())
    jitter = lambda v: u(max(0.0, 1 - v), 1 + v)
    out = {"brightness": jitter(a["brightness"]), "contrast": jitter(a["contrast"]),
           "saturation": jitter(a["saturation"]), "hue": u(-a["hue"], a["hue"])}
    area = u(*a["crop_area"])
    gates = (rand((len(a["posterize_bits"]),)) < a["posterize_p"]).tolist()
    out["posterize_bits"] = min([8.0] + [float(b) for b, on in zip(a["posterize_bits"], gates) if on])
    out["sharpness"] = 2.0 if float(rand()) < a["sharpness_p"] else 1.0
    out["blur_sigma"] = u(*a["blur_sigma"])
    out["crop_zoom"] = float(1.0 / np.sqrt(np.float32(area)))
    out["crop_cx"], out["crop_cy"] = u(0.0, 1.0), u(0.0, 1.0)
    return out


def make_batch(tr: dict, cfg_file: dict, seed: int, index: int, device):
    """-> (a dict of (B, T, ...) device tensors, the rows' instructions)."""
    g = torch.Generator(device=device).manual_seed(P.stream_seed(seed, TRAFFIC + index))
    m = cfg_file["model"]
    b, t = tr["batch"], tr["window"]
    h, w = cfg_file["vision"]["image_size"]
    randint = lambda lo, hi, *s, dt=torch.int32: torch.randint(lo, hi, s, generator=g, device=device, dtype=dt)

    def dealt(values):
        return [values[i] for i in torch.randperm(len(values), generator=g, device=device).tolist()]

    valid = torch.as_tensor(dealt(tr["valid_steps"]), device=device)
    start = torch.as_tensor(dealt(P.spread(0, tr["episode_start_max"], b)), device=device)
    steps = torch.arange(t, device=device)[None]
    actions = randint(0, m["num_actions"], b, t)
    batch = {
        "rgb_nav": randint(0, 256, b, t, h, w, 3, dt=torch.uint8),
        "rgb_manip": randint(0, 256, b, t, h, w, 3, dt=torch.uint8),
        "last_actions": randint(0, m["num_actions"] + 1, b, t),
        "actions": torch.where(steps < valid[:, None], actions, -1).to(torch.int32),
        "time_ids": (start[:, None] + steps).to(torch.int32),
        "an_object_is_in_hand": randint(0, 3, b, t),
    }
    texts = tr["instructions"]
    return batch, dealt([texts[i % len(texts)] for i in range(b)])


def half_batch(batch: dict, texts):
    """The fault "half of the batch left out": the first half of the rows."""
    b = len(texts)
    return {k: v[: b // 2] for k, v in batch.items()}, texts[: b // 2]


class Driver:
    def __init__(self, spec, seed: int, device):
        self.spec, self.seed, self.device = spec, seed, torch.device(device)
        self.tr, self.cfg_file = spec.traffic, spec.config
        self.m = self.cfg_file["model"]
        self.specs = {
            "tower": (P.towers_spec(self.m, 1), TOWER_W),
            "vit": (P.vit_spec(self.cfg_file["vision"]), VIT_W),
            "text": (P.text_spec(self.cfg_file["text"]), TEXT_W),
        }
        self.compared = None
        self._out = []

    def weights(self, part: str):
        spec, stream = self.specs[part]
        return P.make_weights(spec, self.seed, stream, self.device)

    def batches(self):
        return [make_batch(self.tr, self.cfg_file, self.seed, i, self.device) for i in range(self.tr["pool"])]

    def _step(self, prepared):
        tr = self.trainer
        self.state, metrics = tr._bc_step(self.state, tr.attach_text(prepared), self.aug)
        return metrics["bc_loss"]

    def setup(self) -> None:
        from safevla_tpu_torch.preprocessing.augment import AugmentParams
        from safevla_tpu_torch.training.offline import OfflineTrainer

        cfg = program_config(self.cfg_file, 1)
        self.trainer = OfflineTrainer(cfg, device=self.device)
        policy = self.trainer.policy
        w0 = self.weights("tower")
        strict_load(policy.towers, P.served(w0, self.specs["tower"][0]))
        for part, module in (("vit", policy.vit), ("text", policy.t5)):
            strict_load(module, P.served(self.weights(part), self.specs[part][0]))
        self.state = self.trainer.init_state()
        self.aug = AugmentParams(enabled=1.0, grayscale=0.0, **draw_augment(self.tr, self.seed))
        made = self.batches()
        self.facts = self._facts(made)
        self.pool = [dict({k: v.cpu().numpy() for k, v in batch.items()}, instructions=texts) for batch, texts in made]
        del made
        losses, grad = [], None
        n = self.tr["compared_steps"]
        for i, prepared in enumerate(self.trainer.prepared_batches(iter(self.pool[:n]))):
            losses.append(float(self._step(prepared)))
            if i == 0:
                grad = {k: float(mu.norm()) for k, mu in zip(self.state.tower_params, self.state.opt_state.mu)}
        change = {k: float((p.detach() - w0[k]).norm()) for k, p in self.state.tower_params.items()}
        self.compared = {"loss": losses, "grad": grad, "change": change}

    def _facts(self, made) -> dict:
        """The work one step needs: operations without recompute; the
        attention calls of the ViT and of the fusion layers that run the kernel."""
        m, v = self.m, self.cfg_file["vision"]
        b, t = self.tr["batch"], self.tr["window"]
        gh, gw = m["vision_grid"]
        prefix = 1 + 2 * gh * gw
        s = -(-(prefix + m["text_max_tokens"]) // 16) * 16
        valid = 0.0
        for _, texts in made:
            _, mask = tokenize(texts, m["text_max_tokens"])
            valid += float((prefix + mask.sum(-1)).sum()) * t / len(made)
        frames = 2 * b * t
        n_tok = (v["image_size"][0] // v["patch_size"]) * (v["image_size"][1] // v["patch_size"])
        vit = {"b": frames, "s": v["tokens_padded"], "heads": v["num_heads"], "dh": v["embed_dim"] // v["num_heads"],
               "valid": float(frames * n_tok), "calls": v["depth"]}
        fusion = {"b": b * t, "s": s, "heads": m["fusion_heads"], "dh": m["hidden_size"] // m["fusion_heads"],
                  "valid": valid, "calls": m["fusion_layers"] - 1}
        return {
            "flops_per_step": FL.bc_step_flops(m, v, 1, b, t),
            "samples_per_step": b * t,
            "attention_fwd": [vit, fusion],
            "attention_bwd": [fusion],
        }

    def window(self, seconds: float) -> dict:
        batches = self.trainer.prepared_batches(itertools.cycle(self.pool))
        waits = []
        try:
            prepared = next(batches)
            synchronize(self.device)
            t0 = time.perf_counter()
            steps = 0
            while True:
                self._out.append(self._step(prepared))
                steps += 1
                if time.perf_counter() - t0 >= seconds:
                    break
                w = time.perf_counter()
                prepared = next(batches)
                waits.append(time.perf_counter() - w)
            synchronize(self.device)
            t1 = time.perf_counter()
        finally:
            batches.close()
        return {"t0": t0, "t1": t1, "steps": steps, "data_wait_s": waits, "facts": self.facts}

    def outcomes(self):
        return [math.isfinite(float(x)) for x in self._out]

    def free(self) -> None:
        self.trainer = self.state = self.pool = None
        self._out = []

    def reference(self, numerics=None, half: bool = False) -> dict:
        """The plain reference over the compared steps, from the seed's weights
        and batches (made again here); `half` runs the half-batch fault."""
        from port_bench.reference.bc import BCLearner
        from port_bench.reference.tower import F32

        w0 = self.weights("tower")
        ref = BCLearner(w0, self.weights("vit"), self.weights("text"), self.cfg_file, numerics or F32)
        aug = draw_augment(self.tr, self.seed)
        losses, grad = [], None
        for i, (batch, texts) in enumerate(self.batches()[: self.tr["compared_steps"]]):
            if half:
                batch, texts = half_batch(batch, texts)
            losses.append(ref.step(batch, texts, aug, self.cfg_file["offline"]["lr"]))
            if i == 0:
                grad = {k: float(v.norm()) for k, v in ref.opt.mu.items()}
        change = {k: float((ref.params[k] - w0[k]).norm()) for k in w0}
        return {"loss": losses, "grad": grad, "change": change}
