"""The port's sync RolloutRunner (and one update on what it collected)
against the JAX package's.

One tiny f32 policy (`tests/torch_port_tiny.py`: seeded random weights that
the JAX learner's `init` takes in and `load_jax_params` carries into the
port), B=4 FakeController streams at 28x42 in two overlap groups, T=6 steps
per window, augmentation off, the T5 in f32 on both sides (the JAX package
runs it in bf16 by default, whose roundings the two frameworks place
differently). The JAX runner collects two windows (the
second starts from the first's bootstrap act); the port's runner then
collects two windows on the same environment streams with the JAX runner's
action draws replayed (`RolloutRunner._draw_actions` is the port's one
draw; the two frameworks' generators differ by design). The task samplers
draw from the global `random` / `np.random`: each side runs whole after
reseeding both.

Every batch key must match: integer keys, rewards, costs and masks exactly;
f32 floats at atol 1e-4; the bf16-stored DINO features and text table
within one bf16 rounding (rtol 2^-8, atol 1e-4): an f32 difference of 1e-7
can round to the neighbouring bf16 value. Then one stage-1 Learner.update on
each side from the second window: metrics and tower weights at atol 1e-4,
each weight's change at 1e-5 (an update moves a weight by at most 4 Adam
steps of 2e-5)."""

import dataclasses
import functools
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_tiny as tiny
from test_rollout_training import make_sampler_factory as jax_sampler_factory
from safevla_tpu.algo.learner import Learner as JaxLearner
from safevla_tpu.config import Config as JaxConfig
from safevla_tpu.models import actor_critic as jac
from safevla_tpu.models import convert
from safevla_tpu.models import t5 as jt5
from safevla_tpu.rollout.env_pool import EnvPool as JaxEnvPool
from safevla_tpu.rollout.runner import RolloutRunner as JaxRolloutRunner
from safevla_tpu_torch.algo.learner import Learner
from safevla_tpu_torch.config import Config, ModelConfig
from safevla_tpu_torch.envs.fake_tasks import make_sampler_factory
from safevla_tpu_torch.models import actor_critic as pac
from safevla_tpu_torch.models import t5 as pt5
from safevla_tpu_torch.rollout.env_pool import EnvPool
from safevla_tpu_torch.rollout.runner import RolloutRunner

B, T, GROUPS, ENV_SEED, COST = 4, 6, 2, 3, 3.0
EXACT = {"prev_actions", "not_reset", "object_in_hand", "time_step", "traj_idx", "text_idx",
         "expert_pickupable", "actions", "rewards", "costs", "masks", "text_mask"}
BF16 = {"dino_nav", "dino_manip", "text_hidden"}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    yield from tiny.one_torch_thread()


@pytest.fixture(scope="module", autouse=True)
def _f32_t5():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jac, "T5Config", functools.partial(jt5.T5Config, dtype=jnp.float32))
        mp.setattr(pac, "T5Config", functools.partial(pt5.T5Config, dtype=torch.float32))
        yield


def _reseed():
    random.seed(ENV_SEED)
    np.random.seed(ENV_SEED)


def _pool(pool_cls, factory):
    return pool_cls(factory(max_steps=5, image_hw=(28, 42)), num_streams=B, num_workers=0)


@pytest.fixture(scope="module")
def jax_side(tiny_model_cfg):
    with pytest.MonkeyPatch.context() as mp:
        tiny.register_tiny_vit(mp)
        mcfg = tiny.model_cfg(tiny_model_cfg)
        jpol = jac.SafeVLAPolicy(mcfg)
        params = tiny.random_params(jpol, seed=4)
        mp.setattr(jpol, "init_params", lambda rng, text_len=None: jax.tree.map(jnp.asarray, params))
        cfg = JaxConfig()
        cfg.model = mcfg
        cfg.train.num_train_processes = B
        cfg.train.use_data_augmentation = False
        cfg.ppo.num_steps = T
        learner = JaxLearner(jpol, cfg)
        ts = learner.init(jax.random.PRNGKey(0))
        _reseed()
        pool = _pool(JaxEnvPool, jax_sampler_factory)
        runner = JaxRolloutRunner(jpol, cfg, pool, seed=0, overlap_groups=GROUPS)
        act_params = {"towers": ts.tower_params, **ts.frozen_params}
        batches = [runner.collect(act_params, T)[0] for _ in range(2)]
        pool.close()
        batches = [{k: np.asarray(v) for k, v in b.items()} for b in batches]
        new_ts, metrics = learner.update(ts, batches[1], COST, 1)
        yield mcfg, params, batches, ts, new_ts, metrics


def _port_cfg(mcfg):
    cfg = Config(ModelConfig(**dataclasses.asdict(mcfg)))
    cfg.train.num_train_processes = B
    cfg.train.use_data_augmentation = False
    return cfg


def _port_collect(cfg, policy, windows=2, replay=None, seed=0):
    _reseed()
    pool = _pool(EnvPool, make_sampler_factory)
    runner = RolloutRunner(policy, cfg, pool, seed=seed, overlap_groups=GROUPS)
    if replay is not None:
        runner._draw_actions = lambda logits, global_step: torch.as_tensor(replay[global_step])
    batches = [runner.collect(T)[0] for _ in range(windows)]
    pool.close()
    return batches


def _replay(batches):
    """The JAX draws in the port runner's draw order (each group's act at
    t = 0..T-1 of each window; a window's step 0 is the last window's
    bootstrap act), then the last bootstrap acts, which no batch records."""
    g = B // GROUPS
    seq = [b["actions"][i * g : (i + 1) * g, t] for b in batches for t in range(T) for i in range(GROUPS)]
    return [a.astype(np.int64) for a in seq] + [np.zeros(g, np.int64)] * GROUPS


@pytest.fixture(scope="module")
def port_side(jax_side):
    mcfg, params, jbatches, *_ = jax_side
    cfg = _port_cfg(mcfg)
    policy = tiny.port_policy(mcfg, params)
    learner = Learner(policy, cfg)
    pts = learner.init()
    batches = _port_collect(cfg, policy, replay=_replay(jbatches))
    got = [{k: v.float().numpy() if v.dtype == torch.bfloat16 else v.numpy() for k, v in b.items()}
           for b in batches]
    pts, metrics = learner.update(pts, batches[1], COST, 1)
    return cfg, policy, got, pts, metrics


@pytest.mark.parametrize("window", [0, 1])
def test_collected_windows_match_jax(jax_side, port_side, window):
    want, got = jax_side[2][window], port_side[2][window]
    assert set(got) == set(want)
    for k, w in want.items():
        g = got[k]
        assert g.shape == w.shape, k
        if k in EXACT:
            np.testing.assert_array_equal(g, w, err_msg=k)
        elif k in BF16:
            np.testing.assert_allclose(g, w.astype(np.float32), rtol=2**-8, atol=1e-4, err_msg=k)
        else:
            np.testing.assert_allclose(g, w, atol=1e-4, err_msg=k)
    assert want["masks"][:, 1:].min() == 0.0  # episodes of 5 steps: resets inside the window


def test_update_on_the_collected_window_matches_jax(jax_side, port_side):
    mcfg, _, _, jts_old, jts, jmetrics = jax_side
    _, policy, _, pts, metrics = port_side
    assert set(metrics) == set(jmetrics)
    for k in jmetrics:
        np.testing.assert_allclose(float(metrics[k]), float(jmetrics[k]), atol=1e-4, err_msg=k)
    for t, tower in enumerate(policy.towers):
        sd = {k: v.detach().float().clone() for k, v in tower.state_dict().items()}
        got = convert.import_tower_state_dict(
            sd, num_tx_layers=mcfg.num_tx_layers, combiner_layers=mcfg.combiner_layers
        )
        pick = lambda tree: jax.tree.map(lambda x: np.asarray(x)[t], tree)
        want = jax.tree_util.tree_leaves_with_path(pick(jts.tower_params))
        old = jax.tree.leaves(pick(jts_old.tower_params))
        for (path, w), g, o in zip(want, jax.tree.leaves(got), old):
            name = f"tower {t} {jax.tree_util.keystr(path)}"
            np.testing.assert_allclose(np.asarray(g), w, atol=1e-4, err_msg=name)
            np.testing.assert_allclose(np.asarray(g) - o, w - o, atol=1e-5, err_msg=name)
    assert pts.step == int(jts.step) == B * T


def test_collect_is_deterministic_given_the_seed(jax_side):
    """The port's own draws (device generator seeded with `seed`): the same
    seed and environment streams give the same batches; another seed other
    actions."""
    mcfg, params = jax_side[:2]
    cfg = _port_cfg(mcfg)
    policy = tiny.port_policy(mcfg, params)
    runs = [_port_collect(cfg, policy, seed=s) for s in (7, 7, 8)]
    for k in runs[0][0]:
        for w in range(2):
            assert torch.equal(runs[0][w][k], runs[1][w][k]), k
    assert not torch.equal(runs[0][0]["actions"], runs[2][0]["actions"])


def test_merged_action_fetch_matches_per_group_and_jax(jax_side, port_side, monkeypatch):
    """`SAFEVLA_MERGED_FETCH=1`: one blocking fetch per time step (and one
    device concat, timed as dispatch) instead of one per (group, step). On
    JAX's draws, both windows equal the per-group windows bit for bit, and
    the JAX runner's merged windows."""
    mcfg, params, jbatches = jax_side[:3]
    monkeypatch.setenv("SAFEVLA_MERGED_FETCH", "1")
    cfg = _port_cfg(mcfg)
    _reseed()
    pool = _pool(EnvPool, make_sampler_factory)
    runner = RolloutRunner(tiny.port_policy(mcfg, params), cfg, pool, seed=0, overlap_groups=GROUPS)
    replay = _replay(jbatches)
    runner._draw_actions = lambda logits, global_step: torch.as_tensor(replay[global_step])
    windows = [runner.collect(T) for _ in range(2)]
    merged = [batch for batch, _ in windows]
    pool.close()
    assert runner._merged_fetch
    assert runner.timer.counts["action_fetch"] == 2 * T  # per-group: 2 * T * GROUPS
    assert runner.timer.counts["dispatch"] == 2 * T * (GROUPS + 1) + GROUPS
    # each window's stats carry its own seconds of each section, beside the EMA
    for name in ("dispatch", "action_fetch", "env_step", "ingest"):
        per_window = [stats[f"time_total/{name}"] for _, stats in windows]
        assert all(v > 0 for v in per_window) and "time/" + name in windows[1][1]
        assert sum(per_window) == pytest.approx(runner.timer.totals[name])

    with pytest.MonkeyPatch.context() as mp:  # the JAX runner, merged
        tiny.register_tiny_vit(mp)
        jpol = jac.SafeVLAPolicy(mcfg)
        jcfg = JaxConfig()
        jcfg.model = mcfg
        jcfg.train.num_train_processes = B
        jcfg.train.use_data_augmentation = False
        _reseed()
        jpool = _pool(JaxEnvPool, jax_sampler_factory)
        jrunner = JaxRolloutRunner(jpol, jcfg, jpool, seed=0, overlap_groups=GROUPS)
        assert jrunner._merged_fetch
        act_params = jax.tree.map(jnp.asarray, {k: params[k] for k in ("vit", "towers", "t5")})
        jmerged = [{k: np.asarray(v) for k, v in jrunner.collect(act_params, T)[0].items()} for _ in range(2)]
        jpool.close()

    for w in range(2):
        got = {k: v.float().numpy() if v.dtype == torch.bfloat16 else v.numpy() for k, v in merged[w].items()}
        for k, per_group in port_side[2][w].items():
            np.testing.assert_array_equal(got[k], per_group, err_msg=k)
        for k in EXACT:
            np.testing.assert_array_equal(jmerged[w][k], jbatches[w][k], err_msg=k)
            np.testing.assert_array_equal(got[k], jmerged[w][k], err_msg=k)
