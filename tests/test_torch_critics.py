"""The port's mlp and HL-Gauss discrete critic heads against the JAX
package's, on the tests' tiny f32 policy with seeded weights carried by
`load_jax_params`.

* `forward_seq` (values, cost values, value logits, stop-gradient outputs)
  and three `act_step`s (values of the rollout) at atol 1e-4, both heads;
* one `Learner.update` at stage 1 for the discrete critic (its value losses
  are the HL-Gauss cross-entropy): every metric and new weight at atol 1e-4,
  every weight's change at 1e-5, the Lagrange state, as
  `tests/test_torch_learner.py` holds the linear critic;
* the port's `chunked_update` against its `update` for the discrete critic;
* a port tower's `state_dict()` with either head read back by the JAX
  importer (`safevla_tpu/models/convert.py`) equal to the JAX weights, and
  a reference container of those towers restored by the port's importer
  (`models/convert.py::load_reference_towers`) bit for bit."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_tiny as tiny
from test_torch_learner import COST, _assert_same, _port_result
from safevla_tpu.algo.learner import Learner as JaxLearner
from safevla_tpu.config import Config as JaxConfig
from safevla_tpu.models import actor_critic as jac
from safevla_tpu.models import convert as jconvert
from safevla_tpu_torch.algo.learner import Learner
from safevla_tpu_torch.config import Config, ModelConfig
from safevla_tpu_torch.models import convert as pconvert

CRITICS = ["mlp", "discrete"]
TOL = 1e-4
KEYS = ("dino_nav", "dino_manip", "text_hidden", "text_mask", "prev_actions", "not_reset",
        "object_in_hand", "time_step", "traj_idx", "text_idx")
OUTPUTS = ("logits", "values", "c_values", "value_logits", "c_value_logits", "stop_grad_values")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    yield from tiny.one_torch_thread()


@pytest.fixture(scope="module", params=CRITICS)
def carried(request, tiny_model_cfg):
    """(model config, JAX policy, numpy weights, port policy) of one critic
    type; async_fusion_chunk 6 makes the chunked update run 4 chunks."""
    with pytest.MonkeyPatch.context() as mp:
        tiny.register_tiny_vit(mp)
        mcfg = dataclasses.replace(
            tiny_model_cfg, vision_backbone=tiny.VIT, critic_type=request.param, async_fusion_chunk=6
        )
        jpol = jac.SafeVLAPolicy(mcfg)
        params = tiny.random_params(jpol, seed=7)
        yield mcfg, jpol, params, tiny.port_policy(mcfg, params)


def _assert_close(got, want, name):
    if want is None:
        assert got is None, name
        return
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=TOL, err_msg=name)


def test_forward_seq_matches_jax(carried):
    mcfg, jpol, params, policy = carried
    batch = tiny.rollout_batch(mcfg, seed=8)
    fwd = jax.jit(lambda p, *a: {k: getattr(jpol.forward_seq(p, *a), k) for k in OUTPUTS})
    want = fwd(jax.tree.map(jnp.asarray, params), *(jnp.asarray(batch[k]) for k in KEYS))
    with torch.no_grad():
        got = policy.forward_seq(*(torch.from_numpy(batch[k]) for k in KEYS))
    for name in OUTPUTS:
        _assert_close(getattr(got, name), want[name], name)
    if mcfg.critic_type == "discrete":
        assert got.value_logits.shape == (tiny.B, tiny.T, mcfg.hl_gauss_bins)
        # the values are the HL-Gauss read-out of the logits
        torch.testing.assert_close(got.values, policy.towers[1].hl.from_logits(got.value_logits))
    else:
        assert got.value_logits is None


def test_act_step_matches_jax(carried):
    mcfg, jpol, params, policy = carried
    rng = np.random.default_rng(9)
    b, (gh, gw), lt = tiny.B, mcfg.vision_grid, mcfg.text_max_tokens
    text = rng.standard_normal((b, lt, mcfg.text_embed_size)).astype(np.float32)
    mask = np.arange(lt)[None, :] < np.array([[3], [8], [5]])
    jparams = jax.tree.map(jnp.asarray, params)
    jstate = jpol.update_text(jpol.init_state(b), jnp.arange(b), jnp.asarray(text), jnp.asarray(mask))
    pstate = policy.init_state(b)
    pstate = policy.update_text(pstate, torch.arange(b), torch.from_numpy(text), torch.from_numpy(mask))
    jact = jax.jit(jpol.act_step)
    for t in range(3):
        nav, manip = rng.standard_normal((2, b, gh, gw, mcfg.vision_feature_dim)).astype(np.float32)
        prev = rng.integers(0, mcfg.num_actions, b).astype(np.int32)
        not_reset = np.array([int(t > 0), int(t > 0), int(t == 2)], np.int32)
        oih = rng.integers(0, 3, b).astype(np.int32)
        args = (nav, manip, prev, not_reset, oih)
        *want, jstate = jact(jparams, jstate, *(jnp.asarray(a) for a in args))
        with torch.no_grad():
            *got, pstate = policy.act_step(pstate, *(torch.from_numpy(a) for a in args))
        for name, g, w in zip(("logits", "values", "c_values"), got, want):
            _assert_close(g, w, f"act {t} {name}")


@pytest.fixture(scope="module")
def discrete_update(tiny_model_cfg):
    """One stage-1 update of the discrete-critic policy on both sides, and
    the port's chunked update of the same batch from the same weights."""
    with pytest.MonkeyPatch.context() as mp:
        tiny.register_tiny_vit(mp)
        mcfg = dataclasses.replace(
            tiny_model_cfg, vision_backbone=tiny.VIT, critic_type="discrete", async_fusion_chunk=6
        )
        jpol = jac.SafeVLAPolicy(mcfg)
        params = tiny.random_params(jpol, seed=10)
        mp.setattr(jpol, "init_params", lambda rng, text_len=None: jax.tree.map(jnp.asarray, params))
        jcfg = JaxConfig()
        jcfg.model = mcfg
        jlearner = JaxLearner(jpol, jcfg)
        jts = jlearner.init(jax.random.PRNGKey(0))
        batch = tiny.rollout_batch(mcfg, seed=11)
        jts_new, jm = jlearner.update(jts, {k: jnp.asarray(v) for k, v in batch.items()}, COST, 1)
        out = {"jax": (jts, jts_new, jm)}
        for kind in ("update", "chunked_update"):
            learner = Learner(tiny.port_policy(mcfg, params), Config(ModelConfig(**dataclasses.asdict(mcfg))))
            pts, pm = getattr(learner, kind)(learner.init(), batch, COST, 1)
            out[kind] = (_port_result(mcfg, learner, pts, pm), pts)
        return out


def test_discrete_update_matches_jax(discrete_update):
    port, _ = discrete_update["update"]
    jm = discrete_update["jax"][2]
    # the value losses are HL-Gauss cross-entropies: positive, and not the MSE
    assert float(jm["value"]) > 0 and float(jm["c_value"]) > 0
    _assert_same(discrete_update["jax"], port)


def test_discrete_chunked_update_matches_update(discrete_update):
    (mono, ts_mono), (chunk, ts_chunk) = discrete_update["update"], discrete_update["chunked_update"]
    for a, b in zip(ts_mono.tower_params.values(), ts_chunk.tower_params.values()):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(), atol=2e-5, rtol=2e-4)
    assert set(mono["metrics"]) == set(chunk["metrics"])
    for k in ("total", "action", "value", "c_value", "grad_norm"):
        np.testing.assert_allclose(mono["metrics"][k], chunk["metrics"][k], atol=1e-4, rtol=2e-3, err_msg=k)
    assert chunk["multiplier"] == pytest.approx(mono["multiplier"])
    assert ts_chunk.step == ts_mono.step and ts_chunk.opt_state.count == ts_mono.opt_state.count


def test_state_dict_read_back_by_the_jax_importer(carried, tmp_path):
    mcfg, _, params, policy = carried
    critic_keys = sorted(k for k in policy.towers[0].state_dict() if k.startswith("critic."))
    layers = {"mlp": (0, 2, 4), "discrete": (0, 2)}[mcfg.critic_type]
    assert critic_keys == sorted(f"critic.fc.{i}.{w}" for i in layers for w in ("bias", "weight"))
    towers = jax.tree.map(np.asarray, params["towers"])
    container = {}
    for t, ((_, prefix), tower) in enumerate(zip(pconvert.TOWER_PREFIXES, policy.towers)):
        sd = {k: v.detach().clone() for k, v in tower.state_dict().items()}
        back = jconvert.import_tower_state_dict(
            {k: v.numpy() for k, v in sd.items()}, num_tx_layers=mcfg.num_tx_layers,
            combiner_layers=mcfg.combiner_layers, critic_type=mcfg.critic_type,
        )
        want = jax.tree.map(lambda x: x[t], towers)
        assert jax.tree.structure(back) == jax.tree.structure(want)
        for (path, g), w in zip(jax.tree_util.tree_leaves_with_path(back), jax.tree.leaves(want)):
            np.testing.assert_array_equal(np.asarray(g), w, err_msg=jax.tree_util.keystr(path))
        container.update({prefix + k: v for k, v in sd.items()})
    # a reference container with Sequential critics restores by name
    path = tmp_path / "reference.pt"
    torch.save({"model_state_dict": container}, path)
    fresh = tiny.port_policy(mcfg, tiny.random_params(jac.SafeVLAPolicy(mcfg), seed=12))
    pconvert.load_reference_towers(str(path), fresh.towers)
    for a, b in zip(fresh.towers.state_dict().values(), policy.towers.state_dict().values()):
        assert torch.equal(a, b)
