"""The port's GAE, losses, Lagrange multiplier, optax pieces and stage
resolution vs the JAX package, on the same numpy inputs, f32.

Tolerances: atol 1e-5 for GAE and the losses (f32 sums in another order),
1e-6 for the Lagrange ascent and the Adam steps (elementwise arithmetic)."""

from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from safevla_tpu.algo import lagrange as jlag
from safevla_tpu.algo import learner as jlearner
from safevla_tpu.algo import losses as jloss
from safevla_tpu.config import LagrangeConfig as JLagrangeConfig
from safevla_tpu.config import PPOConfig as JPPOConfig
from safevla_tpu.config import TrainConfig as JTrainConfig
from safevla_tpu.config import TrainingStageConfig as JStage
from safevla_tpu.ops import gae as jgae
from safevla_tpu_torch import config as pconfig
from safevla_tpu_torch.algo import lagrange as plag
from safevla_tpu_torch.algo import learner as plearner
from safevla_tpu_torch.algo import losses as ploss
from safevla_tpu_torch.algo import optim
from safevla_tpu_torch.ops import gae as pgae

T, B, A = 12, 5, 20


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _masks(rng):
    masks = np.ones((T + 1, B), np.float32)
    masks[rng.random((T + 1, B)) < 0.2] = 0.0
    return masks


@pytest.mark.parametrize("k", [1, 2])
def test_gae_matches_jax(k):
    rng = np.random.default_rng(k)
    rewards = rng.normal(size=(k, T, B)).astype(np.float32)
    values = rng.normal(size=(k, T + 1, B)).astype(np.float32)
    masks = _masks(rng)
    if k == 1:
        want = jgae.gae_advantages(rewards[0], values[0], masks, 0.99, 0.95)
        got = pgae.gae_advantages(_t(rewards[0]), _t(values[0]), _t(masks), 0.99, 0.95)
    else:
        want = jgae.dual_gae(rewards, values, masks, 0.99, 0.95)
        got = pgae.dual_gae(_t(rewards), _t(values), _t(masks), 0.99, 0.95)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5)


def _loss_inputs(seed=0):
    rng = np.random.default_rng(seed)
    f = lambda *shape: rng.normal(size=shape).astype(np.float32)
    return dict(
        logits=f(B, T, A),
        values=f(B, T),
        actions=rng.integers(0, A, (B, T)).astype(np.int32),
        old_log_probs=(-3.0 + 0.3 * f(B, T)).astype(np.float32),
        advantages=f(B, T),
        c_advantages=f(B, T),
        returns=f(B, T),
        old_values=f(B, T),
        expert=(rng.random((B, T)) < 0.5).astype(np.float32),
    )


LOSS_CASES = {
    "categorical_log_prob": lambda m, x: m.categorical_log_prob(x["logits"], x["actions"]),
    "categorical_entropy": lambda m, x: m.categorical_entropy(x["logits"]),
    "clipped_surrogate": lambda m, x: m.clipped_surrogate(
        x["logits"][..., 0] * 0.1 - 3.0, x["old_log_probs"], x["advantages"], 0.1
    ),
    "value_loss": lambda m, x: m.value_loss(x["values"], x["returns"]),
    "value_loss_clipped": lambda m, x: m.value_loss(
        x["values"], x["returns"], x["old_values"], 0.1, True
    ),
    "ppo_surrogate_loss": lambda m, x: m.ppo_surrogate_loss(
        x["logits"], x["values"], x["actions"], x["old_log_probs"], x["advantages"],
        x["returns"], x["old_values"], 0.1, 0.5, 0.01, True,
    ),
    "safe_ppo_surrogate_loss": lambda m, x: m.safe_ppo_surrogate_loss(
        x["logits"], x["values"], x["actions"], x["old_log_probs"], x["advantages"],
        x["c_advantages"], x["returns"], x["old_values"], 0.7, 0.1, 0.5, 0.01,
    ),
    "imitation_bce_loss": lambda m, x: m.imitation_bce_loss(x["logits"], x["expert"]),
}


@pytest.mark.parametrize("name", list(LOSS_CASES))
def test_losses_match_jax(name):
    x = _loss_inputs()
    want = LOSS_CASES[name](jloss, {k: jnp.asarray(v) for k, v in x.items()})
    got = LOSS_CASES[name](ploss, {k: _t(v) for k, v in x.items()})
    if isinstance(want, tuple):  # (total, metrics)
        assert set(got[1]) == set(want[1])
        got = [got[0], *(got[1][k] for k in sorted(want[1]))]
        want = [want[0], *(want[1][k] for k in sorted(want[1]))]
    else:
        got, want = [got], [want]
    for g, w in zip(got, want):
        np.testing.assert_allclose(np.asarray(g, np.float32), np.asarray(w), atol=1e-5)


@pytest.mark.parametrize(
    "costs,upper_bound",
    [
        ([10.0, 10.0, 10.0, 0.5, 0.0], None),  # climbs, then falls to the projection at 0
        ([0.0, 0.0, 3.0], None),  # starts at the projection
        ([50.0] * 6, 0.1),  # capped by the upper bound
    ],
)
def test_update_lagrange_matches_jax(costs, upper_bound):
    js = jlag.init_lagrange(2.31, 0.001, 0.035, upper_bound)
    ps = plag.init_lagrange(2.31, 0.001, 0.035, upper_bound)
    for c in costs:
        js = jlag.update_lagrange(js, jnp.float32(c), 0.035)
        before = ps.multiplier.clone()
        new = plag.update_lagrange(ps, c, 0.035)
        assert torch.equal(ps.multiplier, before)  # the old state is left as it was
        ps = new
        np.testing.assert_allclose(float(ps.multiplier), float(js.multiplier), atol=1e-6)
        np.testing.assert_allclose(
            float(plag.multiplier_value(ps)), float(jlag.multiplier_value(js)), atol=1e-6
        )
    adam = js.opt_state[0]
    assert ps.opt_state.count == int(adam.count)
    np.testing.assert_allclose(float(ps.opt_state.mu[0]), float(adam.mu), atol=1e-6)
    np.testing.assert_allclose(float(ps.opt_state.nu[0]), float(adam.nu), rtol=1e-6)


@pytest.mark.parametrize("max_norm", [0.5, 1e3])  # clipped, and passed as it is
def test_clip_and_adam_match_optax(max_norm):
    """Three steps over leaves of which one gets no gradient until the last
    step (a head that a later stage starts to train): optax keeps one count."""
    rng = np.random.default_rng(7)
    shapes = [(4, 3), (5,), (2, 2)]
    params = [rng.normal(size=s).astype(np.float32) for s in shapes]
    tx = optax.chain(optax.clip_by_global_norm(max_norm), optax.adam(2e-3))
    jp = [jnp.asarray(p) for p in params]
    jstate = tx.init(jp)
    pp = [torch.from_numpy(p.copy()) for p in params]
    pstate = optim.adam_init(pp)
    for step in range(3):
        grads = [rng.normal(size=s).astype(np.float32) for s in shapes]
        if step < 2:
            grads[1][:] = 0.0
        updates, jstate = tx.update([jnp.asarray(g) for g in grads], jstate, jp)
        jp = optax.apply_updates(jp, updates)
        clipped, norm = optim.clip_by_global_norm([_t(g) for g in grads], max_norm)
        np.testing.assert_allclose(float(norm), float(optax.global_norm(grads)), rtol=1e-6)
        pstate = optim.adam_step(pp, clipped, pstate, 2e-3)
        for a, b in zip(pp, jp):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6)
    assert pstate.count == 3


def test_configs_match_jax():
    assert pconfig.PPOConfig().__dict__ == JPPOConfig().__dict__
    assert pconfig.LagrangeConfig().__dict__ == JLagrangeConfig().__dict__
    jt, pt = JTrainConfig(), pconfig.TrainConfig()
    for k in ("num_train_processes", "max_steps", "seed", "augmentation_version"):
        assert getattr(pt, k) == getattr(jt, k)
    assert [s.__dict__ for s in pt.stages] == [s.__dict__ for s in jt.stages]


@pytest.mark.parametrize(
    "names,weights",
    [
        (["ppo_value_loss", "safe_ppo_value_loss"], None),
        (["ppo_log_loss"], None),
        (["ppo_loss", "imitation_bce_loss"], [2.0, 0.5]),
    ],
)
def test_stage_spec_matches_jax(names, weights):
    want = jlearner.stage_spec_from_config(JStage(names, 1, weights), JPPOConfig())
    got = plearner.stage_spec_from_config(
        pconfig.TrainingStageConfig(names, 1, weights), pconfig.PPOConfig()
    )
    assert tuple(got) == tuple(want)


def test_stage_spec_errors_match_jax():
    for names, weights, match in (
        (["ppo_log_loss"], [1.0, 2.0], "loss_weights"),
        (["no_such_loss"], None, "Unknown loss name"),
    ):
        with pytest.raises(ValueError, match=match):
            plearner.stage_spec_from_config(
                pconfig.TrainingStageConfig(names, 1, weights), pconfig.PPOConfig()
            )


def test_stage_for_step():
    learner = plearner.Learner(SimpleNamespace(device=torch.device("cpu")), pconfig.Config())
    assert [learner.stage_for_step(s) for s in (0, 199_999, 200_000, 999_999, 1_000_000)] == [
        0, 0, 1, 1, 2,
    ]
