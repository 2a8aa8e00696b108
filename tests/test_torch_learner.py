"""The training slice as a whole: the port's Learner.update vs the JAX one.

One tiny f32 policy (three fusion layers, fusion_chunk 8 < B*T, so the
packed attention, its backward and the checkpointed chunks all run) gets
seeded random weights, which the JAX learner's own `init` takes in and
`load_jax_params` carries into the port. Both learners then take the same
packed batch (episode boundaries, an episode-text table) at the default
PPOConfig (4 epochs, global-norm clip 0.5, Adam 2e-5) but for
normalize_advantage=True (the normalised advantages enter stage 1's loss;
stage 0 trains the critics on returns alone).

Compared after each update: every metric and every new tower weight at f32
atol 1e-4; since an update moves a weight by at most ~8e-5 (4 Adam steps of
2e-5), the change of every weight at atol 1e-5 as well; the Lagrange state
and the optimizer's step count exactly or at 1e-6; `step`. Cases: stage 0
(critics only) and stage 1, each from the initial weights, and stage 1
after stage 0, in which the actor tower gets its first gradients at an Adam
count of 4 (a per-parameter count would bias-correct them as steps 1-4).
The stage 0 case is the first update of that sequence: both share one
fixture, so each JAX update compiles once per stage."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch_port_tiny as tiny
from safevla_tpu.algo.learner import Learner as JaxLearner
from safevla_tpu.config import Config as JaxConfig
from safevla_tpu.models import actor_critic as jac
from safevla_tpu.models import convert
from safevla_tpu_torch.algo.learner import Learner
from safevla_tpu_torch.config import Config, ModelConfig

COST = 3.0  # above the cost limit of 2.31, so lambda climbs in stage 1


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    yield from tiny.one_torch_thread()


@pytest.fixture(scope="module")
def setup(tiny_model_cfg):
    with pytest.MonkeyPatch.context() as mp:
        tiny.register_tiny_vit(mp)
        mcfg = tiny.model_cfg(tiny_model_cfg)
        jpol = jac.SafeVLAPolicy(mcfg)
        params = tiny.random_params(jpol, seed=1)
        # the JAX init then compiles a constant instead of the initialisers
        mp.setattr(jpol, "init_params", lambda rng, text_len=None: jax.tree.map(jnp.asarray, params))
        cfg = JaxConfig()
        cfg.model = mcfg
        cfg.ppo.normalize_advantage = True
        learner = JaxLearner(jpol, cfg)  # one compiled update per stage, shared
        ts = learner.init(jax.random.PRNGKey(0))
        batch = tiny.rollout_batch(mcfg, seed=2)
        yield mcfg, learner, ts, params, batch


def _port(mcfg, params):
    cfg = Config(ModelConfig(**dataclasses.asdict(mcfg)))
    cfg.ppo.normalize_advantage = True
    learner = Learner(tiny.port_policy(mcfg, params), cfg)
    return learner, learner.init()


def _port_result(mcfg, learner, pts, pm):
    """What the port's update left, copied out: the learner updates its
    tower weights in place, so a later update would change them."""
    towers = []
    for tower in learner.policy.towers:
        sd = {k: v.detach().float().clone() for k, v in tower.state_dict().items()}
        towers.append(
            convert.import_tower_state_dict(
                sd, num_tx_layers=mcfg.num_tx_layers, combiner_layers=mcfg.combiner_layers,
                critic_type=mcfg.critic_type,
            )
        )
    lag = pts.lagrange
    return {
        "metrics": {k: float(v) for k, v in pm.items()},
        "towers": towers,
        "multiplier": float(lag.multiplier),
        "lagrange_count": lag.opt_state.count,
        "lagrange_mu": float(lag.opt_state.mu[0]),
        "count": pts.opt_state.count,
        "step": pts.step,
    }


def _jax_update(jlearner, jts, batch, stage):
    jts_new, jm = jlearner.update(jts, {k: jnp.asarray(v) for k, v in batch.items()}, COST, stage)
    return jts, jts_new, jm


def _assert_same(jax_step, port):
    jts_old, jts, jm = jax_step
    assert set(port["metrics"]) == set(jm)
    for k in jm:
        np.testing.assert_allclose(port["metrics"][k], float(jm[k]), atol=1e-4, err_msg=k)
    for t, got in enumerate(port["towers"]):
        tower = lambda tree: jax.tree.map(lambda x: np.asarray(x)[t], tree)
        want = jax.tree_util.tree_leaves_with_path(tower(jts.tower_params))
        old = jax.tree.leaves(tower(jts_old.tower_params))
        for (path, w), g, o in zip(want, jax.tree.leaves(got), old):
            name = f"tower {t} {jax.tree_util.keystr(path)}"
            np.testing.assert_allclose(np.asarray(g), w, atol=1e-4, err_msg=name)
            np.testing.assert_allclose(np.asarray(g) - o, w - o, atol=1e-5, err_msg=name)
    jlag = jts.lagrange
    np.testing.assert_allclose(port["multiplier"], float(jlag.multiplier), atol=1e-6)
    assert port["lagrange_count"] == int(jlag.opt_state[0].count)
    np.testing.assert_allclose(port["lagrange_mu"], float(jlag.opt_state[0].mu), atol=1e-6)
    assert port["count"] == int(jts.opt_state[1][0].count)  # chain(clip, adam)
    assert port["step"] == int(jts.step)


@pytest.fixture(scope="module")
def stage0_then_stage1(setup):
    """Two successive updates from the initial weights, stage 0 then stage
    1, on both sides: [(JAX step, port result)] per update."""
    mcfg, jlearner, jts, params, batch = setup
    learner, pts = _port(mcfg, params)
    steps = []
    for stage in (0, 1):
        jax_step = _jax_update(jlearner, jts, batch, stage)
        jts = jax_step[1]
        pts, pm = learner.update(pts, batch, COST, stage)
        steps.append((jax_step, _port_result(mcfg, learner, pts, pm)))
    return steps


@pytest.mark.parametrize("stage", [0, 1])
def test_update_matches_jax(setup, stage0_then_stage1, stage):
    if stage == 0:  # the first update of the sequence
        jax_step, port = stage0_then_stage1[0]
    else:
        mcfg, jlearner, ts, params, batch = setup
        learner, pts = _port(mcfg, params)
        pts, pm = learner.update(pts, batch, COST, stage)
        jax_step, port = _jax_update(jlearner, ts, batch, stage), _port_result(mcfg, learner, pts, pm)
        assert port["multiplier"] > 0.001  # lambda climbed
    _assert_same(jax_step, port)


def test_stage0_then_stage1_matches_jax(setup, stage0_then_stage1):
    batch = setup[4]
    for jax_step, port in stage0_then_stage1:
        _assert_same(jax_step, port)
    port = stage0_then_stage1[-1][1]
    assert port["count"] == 8 and port["step"] == 2 * batch["rewards"].size
