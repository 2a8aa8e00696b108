"""The weight carry, JAX tree -> port -> JAX tree.

`load_jax_params` fills the port from a JAX SafeVLAPolicy tree; the port's
state dict, read back by the JAX package's own importers for reference
torch checkpoints (`convert.import_tower_state_dict`, `import_t5`,
`import_dinov2`), must give the original tree leaf for leaf. That holds only
if every port module carries the reference's torch name and layout."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from safevla_tpu.models import actor_critic as jac
from safevla_tpu.models import convert
from safevla_tpu.models import t5 as jt5
from safevla_tpu.models import vit as jvit
from safevla_tpu_torch.config import ModelConfig
from safevla_tpu_torch.models import actor_critic as pac
from safevla_tpu_torch.models import t5 as pt5
from safevla_tpu_torch.models import vit as pvit
from safevla_tpu_torch.models.from_jax import load_jax_params

VIT = "torch_port_tiny_f32"


def _leaves(tree):
    return {jax.tree_util.keystr(k): np.asarray(v) for k, v in jax.tree_util.tree_leaves_with_path(tree)}


def _assert_same(got, want):
    got, want = _leaves(got), _leaves(want)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.fixture(scope="module")
def carried(tiny_model_cfg):
    """A tiny f32 policy on both sides: the port stores the frozen ViT's and
    T5's bf16-computed linears in bf16 (the cast JAX applies at every use),
    which a bit-exact round trip cannot go through, so the ViT and T5 configs
    are switched to f32."""
    kw = dict(embed_dim=32, depth=1, num_heads=2, img_height=28, img_width=42)
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(jvit.VIT_CONFIGS, VIT, jvit.DinoViTConfig(dtype=jnp.float32, **kw))
        mp.setitem(pvit.VIT_CONFIGS, VIT, pvit.DinoViTConfig(dtype=torch.float32, **kw))
        mp.setattr(jac, "T5Config", functools.partial(jt5.T5Config, dtype=jnp.float32))
        mp.setattr(pac, "T5Config", functools.partial(pt5.T5Config, dtype=torch.float32))
        cfg = dataclasses.replace(tiny_model_cfg, vision_backbone=VIT)
        params = jax.device_get(jax.jit(jac.SafeVLAPolicy(cfg).init_params)(jax.random.PRNGKey(1)))
        policy = pac.SafeVLAPolicy(ModelConfig(**dataclasses.asdict(cfg)), device="cpu")
        load_jax_params(policy, params)
    return cfg, params, policy


def _sd(module):
    return {k: v.float() for k, v in module.state_dict().items()}


def test_towers_round_trip(carried):
    cfg, params, policy = carried
    for t in range(cfg.num_towers):
        back = convert.import_tower_state_dict(
            _sd(policy.towers[t]),
            num_tx_layers=cfg.num_tx_layers,
            combiner_layers=cfg.combiner_layers,
        )
        want = jax.tree.map(lambda x: x[t], params["towers"])
        _assert_same(back, want)


def test_t5_round_trip(carried):
    cfg, params, policy = carried
    _assert_same(convert.import_t5(_sd(policy.t5)), params["t5"])


def test_vit_round_trip(carried):
    """import_dinov2 re-interpolates a hub pos_embed from its square grid, so
    the port's already-interpolated pos_embed is compared directly."""
    cfg, params, policy = carried
    sd = _sd(policy.vit)
    np.testing.assert_array_equal(sd["pos_embed"].numpy(), params["vit"]["params"]["pos_embed"])
    sd["pos_embed"] = torch.zeros(1, 1 + 4, 32)  # any square grid
    back = convert.import_dinov2(sd, depth=1, grid=(2, 3))
    back["params"]["pos_embed"] = params["vit"]["params"]["pos_embed"]
    _assert_same(back, params["vit"])


def test_load_is_strict(carried):
    cfg, params, policy = carried
    broken = jax.tree.map(lambda x: x, params)
    del broken["towers"]["params"]["actor_head"]
    with pytest.raises(KeyError):
        load_jax_params(policy, broken)


def test_tower_weights_stay_f32_at_a_bf16_compute_dtype(carried, monkeypatch):
    """The towers keep f32 master weights whatever the compute dtype (flax
    Dense: param_dtype f32, cast at use), so the carry is bit-exact."""
    cfg, params, _ = carried
    kw = dict(embed_dim=32, depth=1, num_heads=2, img_height=28, img_width=42)
    monkeypatch.setitem(pvit.VIT_CONFIGS, VIT, pvit.DinoViTConfig(**kw))  # bf16 ViT
    bf16 = dataclasses.replace(cfg, vision_backbone=VIT, compute_dtype="bfloat16")
    policy = pac.SafeVLAPolicy(ModelConfig(**dataclasses.asdict(bf16)), device="cpu")
    load_jax_params(policy, params)
    assert {p.dtype for p in policy.towers.parameters()} == {torch.float32}
    for t in range(cfg.num_towers):
        back = convert.import_tower_state_dict(
            dict(policy.towers[t].state_dict()),
            num_tx_layers=cfg.num_tx_layers,
            combiner_layers=cfg.combiner_layers,
        )
        _assert_same(back, jax.tree.map(lambda x: x[t], params["towers"]))
