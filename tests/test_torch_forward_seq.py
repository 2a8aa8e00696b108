"""Port SafeVLAPolicy.forward_seq vs the JAX one, f32, tiny config.

Three text layouts (an episode table indexed by text_idx, per-step text,
one instruction per stream); three fusion layers, so layers 0-1 run the
packed attention; fusion_chunk 8 < B*T = 24, so the chunks and their
checkpointing run. Outputs (logits, values, cost values, stop-gradient
values) at atol 1e-4 for each layout; for the update's layout also the
gradient of a scalar of the outputs with respect to every tower weight,
taken through the checkpointed chunks and the attention's autograd
Function, at atol 1e-4. And one tower's `full_seq` (the single-tower
forward in one piece) in each layout against JAX's."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_tiny as tiny
from safevla_tpu.models import actor_critic as jac
from safevla_tpu.models import convert

OUTPUTS = ("logits", "values", "c_values", "stop_grad_values")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    yield from tiny.one_torch_thread()


@pytest.fixture(scope="module")
def carried(tiny_model_cfg):
    with pytest.MonkeyPatch.context() as mp:
        tiny.register_tiny_vit(mp)
        mcfg = tiny.model_cfg(tiny_model_cfg)
        jpol = jac.SafeVLAPolicy(mcfg)
        params = tiny.random_params(jpol, seed=4)
        return mcfg, jpol, params, tiny.port_policy(mcfg, params)


KEYS = (
    "dino_nav", "dino_manip", "text_hidden", "text_mask", "prev_actions",
    "not_reset", "object_in_hand", "time_step", "traj_idx",
)


def _jax_outputs(jpol, params, batch):
    text_idx = batch.get("text_idx")

    def run(towers):
        out = jpol.forward_seq(
            {**params, "towers": towers}, *(jnp.asarray(batch[k]) for k in KEYS),
            None if text_idx is None else jnp.asarray(text_idx),
        )
        loss = jnp.sum(out.logits[..., 0]) + jnp.sum(out.values * out.c_values)
        return loss, {name: getattr(out, name) for name in OUTPUTS}

    return run


def _port_outputs(policy, batch):
    text_idx = batch.get("text_idx")
    return policy.forward_seq(
        *(torch.from_numpy(batch[k]) for k in KEYS),
        None if text_idx is None else torch.from_numpy(text_idx),
    )


@pytest.fixture(scope="module")
def jax_table(carried):
    """The JAX outputs and tower gradients for the update's layout (the
    episode-text table), from one compiled program."""
    mcfg, jpol, params, _ = carried
    batch = tiny.rollout_batch(mcfg, seed=5, text_layout="table")
    grads, outputs = jax.jit(jax.grad(_jax_outputs(jpol, params, batch), has_aux=True))(
        jax.tree.map(jnp.asarray, params["towers"])
    )
    return batch, outputs, grads


@pytest.mark.parametrize("text_layout", ["table", "per_step", "per_stream"])
def test_forward_seq_matches_jax(carried, jax_table, text_layout):
    mcfg, jpol, params, policy = carried
    if text_layout == "table":
        batch, want, _ = jax_table
    else:
        batch = tiny.rollout_batch(mcfg, seed=5, text_layout=text_layout)
        _, want = jax.jit(_jax_outputs(jpol, params, batch))(jax.tree.map(jnp.asarray, params["towers"]))
    with torch.no_grad():
        got = _port_outputs(policy, batch)
    for name in OUTPUTS:
        np.testing.assert_allclose(
            getattr(got, name).numpy(), np.asarray(want[name]), atol=1e-4, err_msg=name
        )
    assert got.value_logits is None and got.c_value_logits is None


def test_forward_seq_grads_match_jax(carried, jax_table):
    """The update's layout (episode-text table): the gradient of a scalar of
    the outputs with respect to every tower weight. A gradient is not
    continuous at a ReLU's kink: where a pre-activation lies within rounding
    of 0, the two sides may fall on either side of it, and one weight's
    gradient moves by one term (~1e-3). With these seeds (weights 4, batch
    5) no fusion MLP input lies that close to 0."""
    mcfg, _, _, policy = carried
    policy.zero_grad(set_to_none=True)
    batch, _, jgrads = jax_table
    got = _port_outputs(policy, batch)
    (got.logits[..., 0].sum() + (got.values * got.c_values).sum()).backward()
    for t, tower in enumerate(policy.towers):
        # a weight the outputs do not reach has no .grad here and 0 in JAX
        grads = {
            k: torch.zeros_like(p) if p.grad is None else p.grad for k, p in tower.named_parameters()
        }
        back = convert.import_tower_state_dict(
            grads, num_tx_layers=mcfg.num_tx_layers, combiner_layers=mcfg.combiner_layers
        )
        want_t = jax.tree.map(lambda x: np.asarray(x)[t], jgrads)
        for (path, a), (_, w) in zip(
            jax.tree_util.tree_leaves_with_path(back), jax.tree_util.tree_leaves_with_path(want_t)
        ):
            np.testing.assert_allclose(
                np.asarray(a), w, atol=1e-4, err_msg=f"tower {t} {jax.tree_util.keystr(path)}"
            )


@pytest.mark.parametrize("text_layout", ["table", "per_step", "per_stream"])
def test_tower_full_seq_matches_jax(carried, text_layout):
    """One tower's full-sequence forward in one piece (`PolicyTower.full_seq`)
    against JAX's `tower.apply(..., method=PolicyTower.full_seq)`, tower 1 (a
    critic tower, so not the one `forward_seq`'s logits come from), in each
    of the three text layouts: the (logits, values, value logits, stop-gradient
    values) tuple at atol 1e-4."""
    from safevla_tpu.ops.masks import packed_block_causal_mask as jax_mask
    from safevla_tpu_torch.ops.masks import packed_block_causal_mask

    mcfg, jpol, params, policy = carried
    batch = tiny.rollout_batch(mcfg, seed=6, text_layout=text_layout)
    text_idx = batch.get("text_idx")
    lead = [batch[k] for k in KEYS[:-1]]  # traj_idx goes in as its mask
    tower = jax.tree.map(lambda x: jnp.asarray(x)[1], params["towers"])
    want = jax.jit(functools.partial(jpol.tower.apply, method=jac.PolicyTower.full_seq))(
        tower, *map(jnp.asarray, lead), jax_mask(jnp.asarray(batch["traj_idx"])),
        None if text_idx is None else jnp.asarray(text_idx),
    )
    with torch.no_grad():
        got = policy.towers[1].full_seq(
            *map(torch.from_numpy, lead), packed_block_causal_mask(torch.from_numpy(batch["traj_idx"])),
            None if text_idx is None else torch.from_numpy(text_idx),
        )
    assert got[2] is None and want[2] is None  # the linear critic: no value logits
    for i in (0, 1, 3):
        np.testing.assert_allclose(got[i].numpy(), np.asarray(want[i]), atol=1e-4, err_msg=str(i))
