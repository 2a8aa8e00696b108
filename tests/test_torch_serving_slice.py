"""The serving slice as a whole: the port's InferenceAgent vs the JAX agent.

One JAX SafeVLAPolicy (tiny config, f32, 3 towers) is initialised, its
parameters perturbed with seeded noise and carried into the port with
`load_jax_params`. Both agents then see the same uint8 frames, instructions
and ints for 8 acts, across a reset of one stream (with a new instruction)
and a wrap of the shared cache slot (max_steps 6). The port is driven
through `act()`; the JAX side through its step body `_step_impl`, fed the
augmentation parameters the port sampled. Per step: action probabilities
(as log-probabilities, i.e. logits up to their log-sum-exp), values, cost
values, greedy actions, time_step, pos and the KV cache, at atol 1e-4.

f32 throughout: the tiny ViT is registered in f32 on both sides, the T5
config is switched to f32 on both sides (the JAX package runs T5 in bf16
whatever the compute dtype), and the JAX augmentation runs its f32 geometry.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from safevla_tpu.config import Config as JaxConfig
from safevla_tpu.evaluation.agent import InferenceAgent as JaxAgent
from safevla_tpu.models import actor_critic as jac
from safevla_tpu.models import t5 as jt5
from safevla_tpu.models import vit as jvit
from safevla_tpu.preprocessing.augment import AugmentParams as JaxAugmentParams
from safevla_tpu_torch.config import Config, ModelConfig, TrainConfig
from safevla_tpu_torch.evaluation.agent import InferenceAgent
from safevla_tpu_torch.models import actor_critic as pac
from safevla_tpu_torch.models import t5 as pt5
from safevla_tpu_torch.models import vit as pvit
from safevla_tpu_torch.models.from_jax import load_jax_params

VIT = "torch_port_tiny_f32"
VIT_KW = dict(embed_dim=32, depth=1, num_heads=2, img_height=28, img_width=42, patch_size=14)
B, STEPS, MAX_STEPS = 3, 8, 6
ATOL = 1e-4


def _f32_everywhere(monkeypatch):
    monkeypatch.setenv("SAFEVLA_AUGMENT_F32", "1")
    monkeypatch.setitem(jvit.VIT_CONFIGS, VIT, jvit.DinoViTConfig(dtype=jnp.float32, **VIT_KW))
    monkeypatch.setitem(pvit.VIT_CONFIGS, VIT, pvit.DinoViTConfig(dtype=torch.float32, **VIT_KW))
    monkeypatch.setattr(jac, "T5Config", functools.partial(jt5.T5Config, dtype=jnp.float32))
    monkeypatch.setattr(pac, "T5Config", functools.partial(pt5.T5Config, dtype=torch.float32))


def test_serving_slice_matches_jax(tiny_model_cfg, monkeypatch):
    _f32_everywhere(monkeypatch)
    # three fusion layers, as the default config: layers 0-1 take the packed
    # attention path, the last the CLS-row path
    mcfg = dataclasses.replace(
        tiny_model_cfg, vision_backbone=VIT, max_steps=MAX_STEPS, combiner_layers=3
    )
    jcfg = JaxConfig()
    jcfg.model = mcfg
    jcfg.train.max_steps = MAX_STEPS
    pcfg = Config(ModelConfig(**dataclasses.asdict(mcfg)), TrainConfig(max_steps=MAX_STEPS))

    rng = np.random.default_rng(0)
    params = jax.device_get(jax.jit(jac.SafeVLAPolicy(mcfg).init_params)(jax.random.PRNGKey(0)))
    params = jax.tree.map(
        lambda x: (x + 0.05 * rng.standard_normal(x.shape)).astype(np.float32), params
    )
    policy = pac.SafeVLAPolicy(pcfg.model, device="cpu")
    load_jax_params(policy, params)

    jagent = JaxAgent(jcfg, jax.tree.map(jnp.asarray, params), num_streams=B, seed=123)
    agent = InferenceAgent(pcfg, policy, num_streams=B, seed=123)
    outs = {}

    def spy(step):
        def run(*a):
            outs["step"] = step(*a)
            return outs["step"]

        return run

    monkeypatch.setattr(agent, "_step", spy(agent._step))

    instructions = ["go to the red mug", "find a vase", "pick up the apple on the table"]
    for a in (jagent, agent):
        a.set_instructions(instructions)
    np.testing.assert_allclose(
        agent.state.text_hidden.numpy(), np.asarray(jagent.state.text_hidden), atol=ATOL
    )

    h, w = mcfg.image_size
    jprev = np.zeros(B, np.int32)
    for t in range(STEPS):
        not_reset = np.full(B, int(t > 0), np.int32)
        if t == 4:  # stream 1 starts a new episode with a new instruction
            not_reset[1] = 0
            reset = not_reset == 0
            agent.reset_streams(reset)
            jprev[reset] = 0
            for a in (jagent, agent):
                a.set_instructions([None, "navigate to the bed", None])
        nav = rng.integers(0, 256, (B, h, w, 3), dtype=np.uint8)
        manip = rng.integers(0, 256, (B, h, w, 3), dtype=np.uint8)
        oih = rng.integers(0, 3, B).astype(np.int32)

        actions = agent.act(nav, manip, not_reset, oih)
        aug = JaxAugmentParams(*[jnp.float32(v) for v in agent.aug_params])
        ints = np.stack([jprev, not_reset, oih]).astype(np.int32)
        jaction, jprobs, jv, jcv, jagent.state = jagent._step_impl(
            jagent.params, jagent.state, aug,
            jnp.asarray(np.concatenate([nav, manip])), jnp.asarray(ints),
            jax.random.PRNGKey(t),
        )
        jprev = np.asarray(jaction).astype(np.int32)
        _, probs, v, cv, state = outs["step"]

        assert agent.aug_params.enabled == 1.0  # the sampled set, not identity
        np.testing.assert_allclose(
            torch.log(probs).numpy(), np.log(np.asarray(jprobs)), atol=ATOL
        )
        np.testing.assert_allclose(v.numpy(), np.asarray(jv), atol=ATOL)
        np.testing.assert_allclose(cv.numpy(), np.asarray(jcv), atol=ATOL)
        np.testing.assert_array_equal(actions, jprev)
        np.testing.assert_array_equal(state.time_step.numpy(), np.asarray(jagent.state.time_step))
        assert state.pos == int(jagent.state.pos)
        for k in ("k", "v"):
            np.testing.assert_allclose(
                state.cache[k].numpy(), np.asarray(jagent.state.cache[k]), atol=ATOL
            )
    assert state.pos == STEPS - MAX_STEPS  # the slot wrapped once
