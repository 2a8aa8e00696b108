"""Data parallel: the port's learner on 2 gloo ranks against JAX's dp=2 mesh.

The counterpart of tests/test_parallel.py (and of `__graft_entry__.py::
dryrun_multichip`). The tiny f32 policy of tests/torch_port_tiny.py gets
seeded random weights; JAX's `Learner(mesh=make_mesh(dp=2))` runs on 2 of
the 8 virtual CPU devices that tests/conftest.py provides, the port's
`Learner(mesh=...)` on 2 processes (tests/torch_parallel_ranks.py), each
with its rows of the same (B=4, T=8) window: stage 1 (the Lagrangian, the
advantages normalised over the global batch), 4 epochs. `update` and
`chunked_update` are held to JAX's at f32 1e-5 for every tower weight and
its change, 1e-4 for the metrics, and exactly for the step (the global
batch) and the counts; the ranks end bit-equal. A (dp=2, mdl=2) grid on 4
ranks computes what the dp=2 mesh does. And the runner's group rule is
JAX's (`safevla_tpu/rollout/runner.py`), read from a JAX runner built on
a mesh of the same dp."""

import dataclasses
from collections.abc import Mapping

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch_parallel_ranks as ranks
import torch_port_tiny as tiny
from safevla_tpu.algo.learner import Learner as JaxLearner
from safevla_tpu.config import Config as JaxConfig
from safevla_tpu.models import actor_critic as jac
from safevla_tpu.models import convert
from safevla_tpu.parallel.mesh import make_mesh as jax_make_mesh
from safevla_tpu.parallel.mesh import shard_batch as jax_shard_batch
from safevla_tpu.rollout.runner import RolloutRunner as JaxRunner
from safevla_tpu_torch.rollout.runner import rank_stream_ids, stream_groups

B, T = 4, 8
COST, STAGE = 3.0, 1  # above the cost limit: lambda climbs


def plain(tree):
    """A parameter tree as plain dicts of numpy arrays (what a rank unpickles)."""
    if isinstance(tree, Mapping):
        return {k: plain(v) for k, v in tree.items()}
    return np.asarray(tree)


@pytest.fixture(scope="module")
def setup(tiny_model_cfg, tmp_path_factory):
    """JAX's dp=2 update and chunked update; the port's ranks (dp=2, and the
    (dp=2, mdl=2) grid) run meanwhile: (config, JAX's state, JAX's results,
    the port's ranks)."""
    with pytest.MonkeyPatch.context() as mp:
        tiny.register_tiny_vit(mp)
        mcfg = tiny.model_cfg(tiny_model_cfg)
        jpol = jac.SafeVLAPolicy(mcfg)
        params = tiny.random_params(jpol, seed=1)
        batch = tiny.rollout_batch(mcfg, seed=2, b=B)
        payload = {
            **ranks.model_payload(mcfg, tiny.VIT, tiny.VIT_KW),
            "overrides": {"ppo": {"normalize_advantage": True}},
            "params": plain(params), "batch": batch, "cost": COST, "stage": STAGE,
        }
        started = {
            "dp2": ranks.start_ranks("learner_update", 2, dict(payload, dp=2, mdl=1, kinds=["update", "chunked"]),
                                     tmp_path_factory.mktemp("dp2")),
            "grid": ranks.start_ranks("learner_update", 4, dict(payload, dp=2, mdl=2, kinds=["update"]),
                                      tmp_path_factory.mktemp("grid")),
        }
        mp.setattr(jpol, "init_params", lambda rng, text_len=None: jax.tree.map(jnp.asarray, params))
        cfg = JaxConfig()
        cfg.model = mcfg
        cfg.ppo.normalize_advantage = True
        mesh = jax_make_mesh(dp=2, mdl=1)
        learner = JaxLearner(jpol, cfg, mesh=mesh)
        ts = learner.init(jax.random.PRNGKey(0))
        jbatch = jax_shard_batch(mesh, {k: jnp.asarray(v) for k, v in batch.items()})
        assert len(jbatch["dino_nav"].sharding.device_set) == 2
        want = {
            "update": learner.update(ts, jbatch, COST, STAGE),
            "chunked": learner.chunked_update(ts, jbatch, COST, STAGE),
        }
        yield mcfg, ts, want, {k: r.wait() for k, r in started.items()}


@pytest.fixture(scope="module")
def dp2(setup):
    return setup[3]["dp2"]


def _assert_same(mcfg, jts_old, want, got):
    jts, jm = want
    assert set(got["metrics"]) == set(jm)
    for k in jm:
        np.testing.assert_allclose(got["metrics"][k], float(jm[k]), atol=1e-4, err_msg=k)
    for t, sd in enumerate(got["towers"]):
        port = convert.import_tower_state_dict(
            dict(sd), num_tx_layers=mcfg.num_tx_layers, combiner_layers=mcfg.combiner_layers,
            critic_type=mcfg.critic_type,
        )
        tower = lambda tree: jax.tree.map(lambda x: np.asarray(x)[t], tree)
        want_leaves = jax.tree_util.tree_leaves_with_path(tower(jts.tower_params))
        old = jax.tree.leaves(tower(jts_old.tower_params))
        for (path, w), g, o in zip(want_leaves, jax.tree.leaves(port), old):
            name = f"tower {t} {jax.tree_util.keystr(path)}"
            np.testing.assert_allclose(np.asarray(g), w, atol=1e-5, err_msg=name)
            np.testing.assert_allclose(np.asarray(g) - o, w - o, atol=1e-5, err_msg=name)
    np.testing.assert_allclose(got["multiplier"], float(jts.lagrange.multiplier), atol=1e-6)
    assert got["count"] == int(jts.opt_state[1][0].count)
    assert got["step"] == int(jts.step) == B * T  # the global batch


@pytest.mark.parametrize("kind", ["update", "chunked"])
def test_dp2_matches_jax_dp2_mesh(setup, dp2, kind):
    mcfg, ts, want, _ = setup
    assert [r["dp_index"] for r in dp2] == [0, 1]
    _assert_same(mcfg, ts, want[kind], dp2[0][kind])


@pytest.mark.parametrize("kind", ["update", "chunked"])
def test_dp2_ranks_end_bit_equal(dp2, kind):
    a, b = (r[kind] for r in dp2)
    assert a["metrics"] == b["metrics"] and a["multiplier"] == b["multiplier"]
    for ta, tb in zip(a["towers"], b["towers"]):
        for k in ta:
            np.testing.assert_array_equal(ta[k], tb[k], err_msg=k)


def test_dp2_mdl2_grid_matches_jax_dp2_mesh(setup):
    """4 ranks in a (dp=2, mdl=2) grid: ranks 0-1 and 2-3 share their rows,
    as JAX replicates the batch over mdl; the update is the dp=2 one."""
    mcfg, ts, want, port = setup
    got = port["grid"]
    assert [r["dp_index"] for r in got] == [0, 0, 1, 1]
    assert got[0]["shape"] == {"dp": 2, "mdl": 2}
    _assert_same(mcfg, ts, want["update"], got[0]["update"])


class _StopAfterGroups(Exception):
    pass


class _Pool:
    def __init__(self, n):
        self.num_streams = n

    def initial_steps(self):
        raise _StopAfterGroups


def _jax_groups(b, overlap, dp):
    """JAX's (n_groups, G) for b streams on a dp mesh: a runner built up to
    its first observation (the rule runs before it)."""
    cfg = JaxConfig()
    cfg.model = dataclasses.replace(cfg.model, text_max_tokens=2, text_embed_size=2)
    runner = JaxRunner.__new__(JaxRunner)
    policy = type("P", (), {"init_state": lambda self, g, l: None})()
    mesh = jax_make_mesh(dp=dp, mdl=1) if dp > 1 else None
    try:
        JaxRunner.__init__(runner, policy, cfg, _Pool(b), tokenizer=object(), overlap_groups=overlap, mesh=mesh)
    except _StopAfterGroups:
        return runner.n_groups, runner.G


@pytest.mark.parametrize("b, overlap, dp", [
    (32, 2, 1), (32, 2, 2), (8, 2, 4), (8, 2, 8), (12, 4, 2), (12, 4, 4), (24, 8, 4), (6, 4, 2), (16, 3, 8),
])
def test_stream_groups_match_jax(b, overlap, dp):
    n_groups, g = stream_groups(b, overlap, dp)
    assert (n_groups, g) == _jax_groups(b, overlap, dp)
    ids = [rank_stream_ids(b, n_groups, dp, d) for d in range(dp)]
    assert sorted(i for part in ids for i in part) == list(range(b))  # every stream once
    # JAX's P("dp") rows of each group's (G, ...) leaves
    assert ids[0][: g // dp] == list(range(g // dp))


@pytest.mark.parametrize("b, overlap, dp", [(6, 2, 4), (10, 2, 4)])
def test_stream_groups_raise_as_jax(b, overlap, dp):
    with pytest.raises(ValueError, match="divisible by dp"):
        stream_groups(b, overlap, dp)
    with pytest.raises(ValueError, match="divisible by dp"):
        _jax_groups(b, overlap, dp)
