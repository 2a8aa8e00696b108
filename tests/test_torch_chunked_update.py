"""The async pipeline's update, chunk by chunk: the port against the JAX
package on the CPU, at the tiny config of tests/torch_port_tiny.py.

* `SafeVLAPolicy.embed_time_range` and `decode_from_embeds` against JAX's
  with the same weights (`load_jax_params`), at start_t 0 and at a middle
  chunk, f32 atol 1e-4.
* `Learner.chunked_update` against JAX's on one batch, at stage 0 and stage
  1, held as tests/test_torch_learner.py holds `update` (`_assert_same`:
  metrics and weights 1e-4, weight changes 1e-5, the Lagrange state 1e-6).
  async_fusion_chunk 6 over the (B=3, T=8) window gives forward chunks of 2
  steps and backward chunks of 1: 4 and 8 chunk programs an epoch; 2 epochs
  (tests/test_learner.py's chunked check takes 2 too).
* The port's `chunked_update` against its own `update` at stage 1, to the
  JAX package's own tolerances for the same check (tests/test_learner.py:
  weights atol 2e-5 rtol 2e-4, metrics atol 1e-4 rtol 2e-3, the multiplier,
  the step).
* The generator yields exactly `chunked_program_count` times, and
  `chunk_sizes` is JAX's on a grid of (B, T, async_fusion_chunk), the
  default config's (32, 128, 64) -> (2, 1) among them.

The port's chunked update runs once per stage (a module fixture) for all
three checks.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_tiny as tiny
from safevla_tpu.algo.learner import Learner as JaxLearner
from safevla_tpu.config import Config as JaxConfig
from safevla_tpu.models import actor_critic as jac
from safevla_tpu_torch.algo.learner import Learner
from safevla_tpu_torch.config import Config, ModelConfig
from test_torch_learner import COST, _assert_same, _port_result

ASYNC_CHUNK = 6  # flat samples: chunk_sizes(3, 8) = (2, 1)
EPOCHS = 2


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    yield from tiny.one_torch_thread()


@pytest.fixture(scope="module")
def setup(tiny_model_cfg):
    with pytest.MonkeyPatch.context() as mp:
        tiny.register_tiny_vit(mp)
        mcfg = dataclasses.replace(tiny.model_cfg(tiny_model_cfg), async_fusion_chunk=ASYNC_CHUNK)
        jpol = jac.SafeVLAPolicy(mcfg)
        params = tiny.random_params(jpol, seed=3)
        mp.setattr(jpol, "init_params", lambda rng, text_len=None: jax.tree.map(jnp.asarray, params))
        cfg = JaxConfig()
        cfg.model = mcfg
        cfg.ppo.normalize_advantage = True
        cfg.ppo.update_repeats = EPOCHS
        learner = JaxLearner(jpol, cfg)
        ts = learner.init(jax.random.PRNGKey(0))
        batch = tiny.rollout_batch(mcfg, seed=4)
        yield mcfg, jpol, learner, ts, params, batch


def _port(mcfg, params):
    cfg = Config(ModelConfig(**dataclasses.asdict(mcfg)))
    cfg.ppo.normalize_advantage = True
    cfg.ppo.update_repeats = EPOCHS
    learner = Learner(tiny.port_policy(mcfg, params), cfg)
    return learner, learner.init()


@pytest.fixture(scope="module")
def port_chunked(setup):
    """The port's chunked update from the initial weights at each stage,
    pumped one program at a time: {stage: (learner, TrainState, metrics,
    the copied-out result, the yields)}."""
    mcfg, _, _, _, params, batch = setup
    runs = {}
    for stage in (0, 1):
        learner, pts = _port(mcfg, params)
        it, yields = learner.iter_chunked_update(pts, batch, COST, stage), 0
        while True:
            try:
                next(it)
                yields += 1
            except StopIteration as stop:
                pts, pm = stop.value
                break
        runs[stage] = (learner, pts, pm, _port_result(mcfg, learner, pts, pm), yields)
    return runs


@pytest.mark.parametrize("start_t", [0, 4])
def test_embed_time_range_and_decode_from_embeds_match_jax(setup, start_t):
    mcfg, jpol, _, _, params, batch = setup
    chunk_t = 2
    jparams = jax.tree.map(jnp.asarray, params)
    j = {k: jnp.asarray(v) for k, v in batch.items()}
    want = jpol.embed_time_range(
        jparams, j["dino_nav"], j["dino_manip"], j["text_hidden"], j["text_mask"], j["text_idx"],
        start_t, chunk_t,
    )
    policy = tiny.port_policy(mcfg, params)
    p = {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}
    with torch.no_grad():
        got = policy.embed_time_range(
            p["dino_nav"], p["dino_manip"], p["text_hidden"], p["text_mask"], p["text_idx"],
            start_t, chunk_t,
        )
    assert got.shape == (mcfg.num_towers, tiny.B, chunk_t, mcfg.hidden_size) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)

    # decode over a whole buffer of embeddings (random: the decoder alone)
    rng = np.random.default_rng(start_t)
    emb = rng.standard_normal((mcfg.num_towers, tiny.B, tiny.T, mcfg.hidden_size)).astype(np.float32)
    jout = jpol.decode_from_embeds(
        jparams, jnp.asarray(emb), j["prev_actions"], j["not_reset"], j["object_in_hand"],
        j["time_step"], j["traj_idx"],
    )
    with torch.no_grad():
        out = policy.decode_from_embeds(
            torch.from_numpy(emb), p["prev_actions"], p["not_reset"], p["object_in_hand"],
            p["time_step"], p["traj_idx"],
        )
    for name in ("logits", "values", "c_values"):
        np.testing.assert_allclose(getattr(out, name).numpy(), np.asarray(getattr(jout, name)),
                                   atol=1e-4, err_msg=name)


@pytest.mark.parametrize("stage", [0, 1])
def test_chunked_update_matches_jax(setup, port_chunked, stage):
    _, _, jlearner, jts, _, batch = setup
    jts_new, jm = jlearner.chunked_update(jts, {k: jnp.asarray(v) for k, v in batch.items()}, COST, stage)
    _assert_same((jts, jts_new, jm), port_chunked[stage][3])


def test_chunked_update_matches_the_ports_update(setup, port_chunked):
    mcfg, _, _, _, params, batch = setup
    _, ts_chunk, m_chunk, _, _ = port_chunked[1]
    mono, ts_mono = _port(mcfg, params)
    ts_mono, m_mono = mono.update(ts_mono, batch, COST, 1)
    for a, b in zip(ts_mono.tower_params.values(), ts_chunk.tower_params.values()):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(), atol=2e-5, rtol=2e-4)
    assert set(m_mono) == set(m_chunk)
    for k in ("total", "action", "value", "c_value", "grad_norm"):
        np.testing.assert_allclose(float(m_mono[k]), float(m_chunk[k]), atol=1e-4, rtol=2e-3, err_msg=k)
    assert float(ts_chunk.lagrange.multiplier) == pytest.approx(float(ts_mono.lagrange.multiplier))
    assert ts_chunk.step == ts_mono.step and ts_chunk.opt_state.count == ts_mono.opt_state.count


# (B, T, async_fusion_chunk); None follows fusion_chunk (8), 0 is the whole window
CHUNK_GRID = [(32, 128, 64), (32, 128, 128), (32, 128, 0), (3, 8, 6), (3, 8, None), (4, 6, 5),
              (5, 7, 3), (8, 12, 24), (2, 9, 100), (1, 1, 64)]


def test_program_count_and_chunk_sizes(setup, port_chunked):
    _, jpol, _, _, _, _ = setup
    for stage in (0, 1):
        learner, ts, metrics, _, yields = port_chunked[stage]
        assert yields == learner.chunked_program_count(tiny.B, tiny.T) == 1 + EPOCHS * (4 + 8 + 2)
        assert ts.step == tiny.B * tiny.T and np.isfinite(float(metrics["total"]))
    mcfg = setup[0]
    for b, t, chunk in CHUNK_GRID:
        jcfg = JaxConfig()
        jcfg.model = dataclasses.replace(mcfg, async_fusion_chunk=chunk)
        jcfg.ppo.update_repeats = EPOCHS
        learner.cfg.model = dataclasses.replace(learner.cfg.model, async_fusion_chunk=chunk)
        want = JaxLearner(jpol, jcfg)
        assert learner.chunk_sizes(b, t) == want.chunk_sizes(b, t), (b, t, chunk)
        assert learner.chunked_program_count(b, t) == want.chunked_program_count(b, t), (b, t, chunk)
    learner.cfg.model = dataclasses.replace(learner.cfg.model, async_fusion_chunk=64)
    assert learner.chunk_sizes(32, 128) == (2, 1)
    # Config()'s 4 epochs: 1 + 4 * (64 + 128 + 2) programs a window
    assert Config().ppo.update_repeats == 4
    assert learner.chunked_program_count(32, 128) == 1 + EPOCHS * (64 + 128 + 2)
