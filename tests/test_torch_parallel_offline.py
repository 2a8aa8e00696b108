"""Data parallel BC: one `OfflineTrainer._bc_step` on 2 gloo ranks against
JAX's `OfflineTrainer(mesh=make_mesh(dp=2))`.

tests/test_torch_offline.py's set-up (the tiny f32 policy with one tower,
the T5 in f32 on both sides, JAX's AugmentParams handed to both, f32
augmentation geometry) on a batch of 4 rows whose two ranks hold unequal
counts of valid targets (13 and 10: rows 1 and 3 end early), so the loss,
a masked mean, is held to the global sum over the global count, not to a
mean of the two rank means. Held as there: the metrics at 1e-4 relative,
every tower weight after the AdamW step at 1e-4 and its change at 1e-5,
where AdamW's first step (lr * sign(g)) may go either way only where the
global gradient is zero up to rounding. Then `_eval_step` on a second
batch against JAX's single-device eval step on the stepped weights (JAX's
`_jit_eval` on a mesh does not compile: its scalar outputs carry the
batch's P("dp") sharding): the predictions equal and the loss and accuracy
at 1e-4 relative; the ranks end bit-equal."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parallel_ranks as ranks
import torch_port_tiny as tiny
from safevla_tpu.config import Config as JaxConfig
from safevla_tpu.models.actor_critic import SafeVLAPolicy as JaxPolicy
from safevla_tpu.parallel.mesh import make_mesh as jax_make_mesh
from safevla_tpu.parallel.mesh import shard_batch as jax_shard_batch
from safevla_tpu.preprocessing.augment import sample_augment_params as jax_sample_augment
from safevla_tpu.training import offline as joff
from test_torch_offline import _port_towers, f32_t5
from test_torch_parallel import plain

B, T = 4, 8
INSTRUCTIONS = ["find a mug", "go to the bed", "locate an apple", "go to the sofa"]


def host_batch(mcfg, seed):
    """A collated BC batch of 4 rows: row 1's window is 5 steps long and row
    3's 2 (targets -1 after), row 2 starts mid-episode."""
    rng = np.random.default_rng(seed)
    h, w = mcfg.image_size
    actions = rng.integers(0, mcfg.num_actions, (B, T)).astype(np.int32)
    actions[1, 5:] = -1
    actions[3, 2:] = -1
    last = np.concatenate([np.full((B, 1), mcfg.num_actions, np.int32), actions[:, :-1]], axis=1)
    last[actions == -1] = mcfg.num_actions + 1  # the pad token
    time_ids = np.tile(np.arange(T, dtype=np.int32), (B, 1))
    time_ids[2] += 7
    return {
        "rgb_nav": rng.integers(0, 256, (B, T, h, w, 3), dtype=np.uint8),
        "rgb_manip": rng.integers(0, 256, (B, T, h, w, 3), dtype=np.uint8),
        "last_actions": last,
        "actions": actions,
        "time_ids": time_ids,
        "an_object_is_in_hand": rng.integers(0, 2, (B, T)).astype(np.int32),
        "padding_mask": actions == -1,
        "instructions": INSTRUCTIONS,
    }


@pytest.fixture(scope="module")
def steps(tiny_model_cfg, tmp_path_factory):
    """JAX's BC step on the dp=2 mesh and its single-device eval step, and
    the port's ranks' (started first, run meanwhile)."""
    with pytest.MonkeyPatch.context() as mp:
        tiny.register_tiny_vit(mp)
        f32_t5(mp)
        mp.setenv("SAFEVLA_AUGMENT_F32", "1")
        mcfg = dataclasses.replace(tiny.model_cfg(tiny_model_cfg), num_towers=1)
        params = tiny.random_params(JaxPolicy(mcfg), seed=3)
        jaug = jax_sample_augment(jax.random.PRNGKey(11), version="v2")
        hb, hb_eval = host_batch(mcfg, 0), host_batch(mcfg, 1)
        assert [(hb["actions"][r] != -1).sum() for r in (slice(0, 2), slice(2, 4))] == [13, 10]
        payload = {
            **ranks.model_payload(mcfg, tiny.VIT, tiny.VIT_KW),
            "overrides": {"train": {"augmentation_version": "v2"}},
            "params": plain(params), "aug": [float(v) for v in jaug],
            "host_batch": hb, "eval_batch": hb_eval, "dp": 2, "mdl": 1,
        }
        started = ranks.start_ranks("bc_step", 2, payload, tmp_path_factory.mktemp("bc"))
        mesh = jax_make_mesh(dp=2, mdl=1)
        jcfg = JaxConfig()
        jcfg.model = mcfg
        jtrainer = joff.OfflineTrainer(jcfg, mesh=mesh)
        mp.setattr(jtrainer.policy, "init_params", lambda rng, text_len=None: jax.tree.map(jnp.asarray, params))
        jts = jtrainer.init_state()
        old = jax.tree.map(lambda x: np.asarray(x)[0], jts.tower_params)
        jbatch = jtrainer.attach_text(jtrainer.host_prepare(hb), jts.frozen_params)
        jts, jm = jtrainer._jit_step(jts, jax_shard_batch(mesh, jbatch), jaug)
        jeval = joff.OfflineTrainer(jcfg)
        jts_local = jax.tree.map(lambda x: jax.device_put(np.asarray(x), jax.devices()[0]), jts)
        jev = jeval._jit_eval(jts_local, jeval.prepare_batch(hb_eval, jts_local.frozen_params))
        yield mcfg, old, jts, jm, jev, started.wait()


def test_bc_step_dp2_matches_jax_dp2_mesh(steps):
    mcfg, old, jts, jm, _, port = steps
    got = port[0]
    assert set(got["metrics"]) == set(jm) == {"bc_loss", "accuracy", "grad_norm"}
    for k in jm:
        np.testing.assert_allclose(got["metrics"][k], float(jm[k]), rtol=1e-4, err_msg=k)
    assert got["step"] == int(jts.step) == 1 and got["count"] == 1
    grads = _port_towers(mcfg, {k: torch.from_numpy(v) for k, v in got["grads"].items()})
    towers = _port_towers(mcfg, {k: torch.from_numpy(v) for k, v in got["towers"][0].items()})
    want = jax.tree_util.tree_leaves_with_path(jax.tree.map(lambda x: np.asarray(x)[0], jts.tower_params))
    lr, flips, total = 1e-4, 0, 0
    assert lr == JaxConfig().offline.lr
    floor = 1e-3 * max(np.abs(np.asarray(g)).max() for g in jax.tree.leaves(grads))
    for (path, w), g, o, gr in zip(want, jax.tree.leaves(towers), jax.tree.leaves(old), jax.tree.leaves(grads)):
        name = jax.tree_util.keystr(path)
        g, gr = np.asarray(g), np.abs(np.asarray(gr))
        flip = np.abs((g - o) - (w - o)) > 1e-5
        # a step that went the other way: only where the gradient is zero up
        # to rounding, and never by more than one step
        assert np.all(gr[flip] < floor), name
        step = lr * (1 + 1e-4 * np.abs(o[flip])) + 1e-7
        assert np.all(np.abs((g - o)[flip]) <= step) and np.all(np.abs((w - o)[flip]) <= step), name
        np.testing.assert_allclose(g[~flip], w[~flip], atol=1e-4, err_msg=name)
        flips, total = flips + int(flip.sum()), total + g.size
    assert flips < 1e-3 * total, (flips, total)


def test_bc_eval_dp2_matches_jax_dp2_mesh(steps):
    *_, jev, port = steps
    np.testing.assert_array_equal(np.concatenate([r["eval"]["preds"] for r in port]), np.asarray(jev["preds"]))
    np.testing.assert_array_equal(np.concatenate([r["eval"]["valid"] for r in port]), np.asarray(jev["valid"]))
    for k in ("val_loss", "val_accuracy"):
        np.testing.assert_allclose(port[0]["eval"][k], float(jev[k]), rtol=1e-4, err_msg=k)


def test_bc_ranks_end_bit_equal(steps):
    a, b = steps[-1]
    assert a["metrics"] == b["metrics"]
    assert (a["eval"]["val_loss"], a["eval"]["val_accuracy"]) == (b["eval"]["val_loss"], b["eval"]["val_accuracy"])
    for k in a["towers"][0]:
        np.testing.assert_array_equal(a["towers"][0][k], b["towers"][0][k], err_msg=k)
