"""The offline (behaviour cloning) slice: the port against the JAX package.

One tiny f32 policy with one tower (tests/torch_port_tiny.py's config:
three fusion layers, `fusion_chunk` 8 < B*T = 24, so the chunking and the
checkpointed chunks run) gets seeded random weights on the JAX side, which
`load_jax_params` carries into the port (the T5 config switched to f32 on
both sides, as tests/test_torch_serving_slice.py does: the JAX package runs
it in bf16). A host batch made with numpy from a
seed (uint8 frames, padded windows with -1 targets, instructions) goes
through each side's `host_prepare` / `attach_text` (the frozen T5) and one
`_bc_step` with the same AugmentParams (JAX's, converted; f32 augmentation
geometry on the JAX side, SAFEVLA_AUGMENT_F32=1, as the port computes):
metrics at 1e-4 relative, the tower weights at 1e-4 and their change at
1e-5 (as the update's tests). AdamW's first step moves a weight by
lr * sign(g) (its moments start at zero), so where a gradient is zero up to
rounding (the key biases of every attention, whose true gradient is 0 by
the softmax's shift invariance, and a few others) the rounding picks the
direction: a change that differs by more than 1e-5 is allowed only where
the port's gradient is under 1e-3 of the largest of all (0 included: JAX's
rounding may be the one that is not 0), is at most one step
lr (1 + 1e-4 |w|) on both sides, and in under 0.1% of all weights. Then `_eval_step` (predictions equal) and
`per_action_f1` (1e-9), the reference-shaped EarlyFusionCnnTransformer
(1e-4), `cross_entropy_ignore_index` (1e-6) and AdamW against
`optax.adamw` (1e-7 relative). The port alone: `fit` over two epochs of a
miniature CHORES directory (loss falls, a checkpoint per epoch, resume,
restart_optimizer, the checkpoint acting through `build_agent` bit-equal to
the in-memory policy) and `cli.train_offline.main` on the CPU.
"""

import dataclasses
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import torch_port_tiny as tiny
from safevla_tpu.config import Config as JaxConfig
from safevla_tpu.models import actor_critic as jac
from safevla_tpu.models import convert
from safevla_tpu.models import t5 as jt5
from safevla_tpu.models import early_fusion as jef
from safevla_tpu.models.actor_critic import SafeVLAPolicy as JaxPolicy
from safevla_tpu.preprocessing.augment import sample_augment_params as jax_sample_augment
from safevla_tpu.training import offline as joff
from safevla_tpu_torch.algo.optim import adamw_init, adamw_step
from safevla_tpu_torch.config import Config, ModelConfig
from safevla_tpu_torch.evaluation.agent import InferenceAgent
from safevla_tpu_torch.models import actor_critic as pac
from safevla_tpu_torch.models import early_fusion as pef
from safevla_tpu_torch.models import t5 as pt5
from safevla_tpu_torch.models.from_jax import load_jax_params
from safevla_tpu_torch.preprocessing.augment import AugmentParams
from safevla_tpu_torch.training import offline as poff
from test_torch_chores import write_chores_dir

B, T = 3, 8
INSTRUCTIONS = ["find a mug", "go to the bed", "locate an apple"]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    yield from tiny.one_torch_thread()


def host_batch(mcfg, seed):
    """A collated BC batch: row 1's window is 5 steps long (targets -1
    after), row 2 starts mid-episode."""
    rng = np.random.default_rng(seed)
    h, w = mcfg.image_size
    actions = rng.integers(0, mcfg.num_actions, (B, T)).astype(np.int32)
    actions[1, 5:] = -1
    last = np.concatenate([np.full((B, 1), mcfg.num_actions, np.int32), actions[:, :-1]], axis=1)
    last[1, 5:] = mcfg.num_actions + 1  # the pad token
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


def f32_t5(mp):
    mp.setattr(jac, "T5Config", functools.partial(jt5.T5Config, dtype=jnp.float32))
    mp.setattr(pac, "T5Config", functools.partial(pt5.T5Config, dtype=torch.float32))


def _port_cfg(mcfg):
    cfg = Config(ModelConfig(**dataclasses.asdict(mcfg)))
    cfg.train.augmentation_version = "v2"
    return cfg


@pytest.fixture(scope="module")
def setup(tiny_model_cfg):
    """The JAX trainer (its init patched to the seeded weights) and the
    port's, on the same weights and the same host batch."""
    with pytest.MonkeyPatch.context() as mp:
        tiny.register_tiny_vit(mp)
        f32_t5(mp)
        mp.setenv("SAFEVLA_AUGMENT_F32", "1")
        mcfg = dataclasses.replace(tiny.model_cfg(tiny_model_cfg), num_towers=1)
        params = tiny.random_params(JaxPolicy(mcfg), seed=3)
        jcfg = JaxConfig()
        jcfg.model = mcfg
        jtrainer = joff.OfflineTrainer(jcfg)
        mp.setattr(jtrainer.policy, "init_params", lambda rng, text_len=None: jax.tree.map(jnp.asarray, params))
        ptrainer = poff.OfflineTrainer(_port_cfg(mcfg), device="cpu")
        load_jax_params(ptrainer.policy, params)
        jaug = jax_sample_augment(jax.random.PRNGKey(11), version="v2")
        paug = AugmentParams(*[float(v) for v in jaug])
        yield mcfg, params, jtrainer, ptrainer, jaug, paug


def _port_towers(mcfg, state_dict):
    """A port tower's state dict as a JAX tower tree."""
    sd = {k: v.detach().float().clone() for k, v in state_dict.items()}
    return convert.import_tower_state_dict(
        sd, num_tx_layers=mcfg.num_tx_layers, combiner_layers=mcfg.combiner_layers
    )


@pytest.fixture(scope="module")
def bc_steps(setup):
    """One BC step on each side, then each side's eval step on a second batch."""
    mcfg, _, jtrainer, ptrainer, jaug, paug = setup
    hb, hb_eval = host_batch(mcfg, 0), host_batch(mcfg, 1)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SAFEVLA_AUGMENT_F32", "1")
        jts = jtrainer.init_state()
        old = jax.tree.map(lambda x: np.asarray(x)[0], jts.tower_params)
        jbatch = jtrainer.attach_text(jtrainer.host_prepare(hb), jts.frozen_params)
        jts, jm = jtrainer._jit_step(jts, jbatch, jaug)
        jev = jtrainer._jit_eval(jts, jtrainer.prepare_batch(hb_eval, jts.frozen_params))
    pts = ptrainer.init_state()
    pbatch = ptrainer.attach_text(ptrainer.host_prepare(hb))
    loss, _ = ptrainer._bc_loss(pbatch, paug)  # the port's gradient at the old weights
    named = list(ptrainer.policy.towers[0].named_parameters())
    grads = torch.autograd.grad(loss, [p for _, p in named], allow_unused=True)
    grads = {n: (torch.zeros_like(p) if g is None else g) for (n, p), g in zip(named, grads)}
    pts, pm = ptrainer._bc_step(pts, pbatch, paug)
    pev = ptrainer._eval_step(pts, ptrainer.prepare_batch(hb_eval))
    return old, jts, jm, jev, pts, pm, pev, hb_eval, _port_towers(mcfg, grads)


def test_cross_entropy_ignore_index_matches_jax():
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((4, 6, 9)).astype(np.float32) * 3
    targets = rng.integers(0, 9, (4, 6)).astype(np.int32)
    targets[0, 2:] = -1
    targets[3] = -1  # a row with every position ignored
    want = joff.cross_entropy_ignore_index(jnp.asarray(logits), jnp.asarray(targets))
    got = poff.cross_entropy_ignore_index(torch.from_numpy(logits), torch.from_numpy(targets))
    np.testing.assert_allclose(float(got), float(want), rtol=0, atol=1e-6)
    all_ignored = poff.cross_entropy_ignore_index(torch.from_numpy(logits), torch.full((4, 6), -1))
    assert float(all_ignored) == 0.0


def test_adamw_matches_optax_over_three_steps():
    """Three steps of adamw_step against optax.adamw(1e-4), one leaf's
    gradient None (zeros for optax): decayed and counted all the same."""
    rng = np.random.default_rng(1)
    ps = [rng.standard_normal(s).astype(np.float32) for s in ((5, 4), (7,), (3, 2))]
    tx = optax.adamw(1e-4)
    jp = [jnp.asarray(p) for p in ps]
    jst = tx.init(jp)
    tp = [torch.from_numpy(p.copy()) for p in ps]
    st = adamw_init(tp)
    for _ in range(3):
        gs = [rng.standard_normal(p.shape).astype(np.float32) for p in ps]
        updates, jst = tx.update([jnp.asarray(gs[0]), jnp.zeros_like(jp[1]), jnp.asarray(gs[2])], jst, jp)
        jp = optax.apply_updates(jp, updates)
        st = adamw_step(tp, [torch.from_numpy(gs[0]), None, torch.from_numpy(gs[2])], st, 1e-4)
    assert st.count == 3
    for want, got in zip(jp, tp):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-7, atol=0)
    # at lr 0.5 the decay of the None leaf shows: p - lr * 1e-4 * p
    leaf = torch.from_numpy(ps[1].copy())
    adamw_step([leaf], [None], adamw_init([leaf]), 0.5)
    np.testing.assert_allclose(leaf.numpy(), ps[1] * np.float32(1 - 0.5e-4), rtol=1e-7)


def test_bc_step_matches_jax(setup, bc_steps):
    """bc_loss, accuracy and grad_norm at 1e-4 relative; every tower weight
    after the AdamW step at 1e-4 and its change at 1e-5."""
    mcfg, _, _, ptrainer, _, _ = setup
    old, jts, jm, _, pts, pm, _, _, grads = bc_steps
    assert set(pm) == set(jm) == {"bc_loss", "accuracy", "grad_norm"}
    for k in jm:
        np.testing.assert_allclose(float(pm[k]), float(jm[k]), rtol=1e-4, err_msg=k)
    assert pts.step == int(jts.step) == 1 and pts.opt_state.count == 1
    got = _port_towers(mcfg, ptrainer.policy.towers[0].state_dict())
    want = jax.tree_util.tree_leaves_with_path(jax.tree.map(lambda x: np.asarray(x)[0], jts.tower_params))
    lr, flips, total = ptrainer.lr, 0, 0
    floor = 1e-3 * max(np.abs(np.asarray(g)).max() for g in jax.tree.leaves(grads))
    for (path, w), g, o, gr in zip(want, jax.tree.leaves(got), jax.tree.leaves(old), jax.tree.leaves(grads)):
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


def test_eval_step_and_f1_match_jax(setup, bc_steps):
    _, _, jtrainer, ptrainer, _, _ = setup
    _, _, _, jev, _, _, pev, hb_eval, _ = bc_steps
    np.testing.assert_array_equal(pev["preds"].numpy(), np.asarray(jev["preds"]))
    np.testing.assert_array_equal(pev["valid"].numpy(), np.asarray(jev["valid"]))
    np.testing.assert_allclose(float(pev["val_loss"]), float(jev["val_loss"]), rtol=1e-4)
    want = jtrainer.per_action_f1(np.asarray(jev["preds"]), hb_eval["actions"])
    got = ptrainer.per_action_f1(pev["preds"].numpy(), hb_eval["actions"])
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-9, err_msg=k)


def test_early_fusion_forward_matches_jax(setup, monkeypatch):
    """The reference-shaped facade: loss and logits of its mock batch."""
    mcfg, params, *_ = setup
    tiny.register_tiny_vit(monkeypatch)
    f32_t5(monkeypatch)
    monkeypatch.setattr(JaxPolicy, "init_params", lambda self, rng, text_len=None: jax.tree.map(jnp.asarray, params))
    jmodel = jef.EarlyFusionCnnTransformer.build_model(cfg=mcfg)
    pmodel = pef.EarlyFusionCnnTransformer.build_model(cfg=ModelConfig(**dataclasses.asdict(mcfg)), device="cpu")
    load_jax_params(pmodel.policy, params)
    batch = pmodel.mock_batch(B=2, T=6)
    for k, v in jmodel.mock_batch(B=2, T=6).items():
        np.testing.assert_array_equal(np.asarray(batch[k]), np.asarray(v), err_msg=k)
    want, got = jmodel(batch), pmodel(batch)
    assert set(got) == set(want)
    np.testing.assert_allclose(got["actions_logits"].numpy(), np.asarray(want["actions_logits"]), atol=1e-4)
    np.testing.assert_allclose(float(got["loss"]), float(want["loss"]), atol=1e-4)


@pytest.fixture(scope="module")
def chores_dir(tmp_path_factory):
    return write_chores_dir(tmp_path_factory.mktemp("chores_fit"), lengths=(7, 12))


def _register_test_tiny(monkeypatch):
    """tests/conftest.py's tiny ViT, on the port's side."""
    monkeypatch.setitem(
        tiny.pvit.VIT_CONFIGS, "test_tiny",
        tiny.pvit.DinoViTConfig(embed_dim=32, depth=1, num_heads=2, img_height=28, img_width=42, patch_size=14),
    )


def _fit_cfg(tiny_model_cfg, output_dir):
    mcfg = dataclasses.replace(tiny_model_cfg, num_towers=1)
    cfg = Config(ModelConfig(**dataclasses.asdict(mcfg)))
    cfg.offline.lr = 1e-3
    cfg.train.use_data_augmentation = False
    cfg.train.output_dir = output_dir
    return cfg


def test_fit_checkpoints_resume_and_agent(chores_dir, tiny_model_cfg, tmp_path, monkeypatch):
    """Two epochs over two batches of the CHORES windows (the prefetch
    thread on): the loss falls, each epoch writes step_<n>; a new trainer
    resumes at epoch 2 (and trains no more), restart_optimizer zeroes the
    AdamW state; the last checkpoint, restored through build_agent, acts
    bit-equal to the in-memory policy."""
    from safevla_tpu_torch.data.chores import ChoresDataset, collate_window_batch

    _register_test_tiny(monkeypatch)
    cfg = _fit_cfg(tiny_model_cfg, str(tmp_path))
    ds = ChoresDataset(chores_dir, "train", sliding_window=6)

    def batches():
        yield collate_window_batch([ds[i] for i in range(2)], 6, ds.pad_token)
        yield collate_window_batch([ds[i] for i in range(2, 4)], 6, ds.pad_token)

    fixed = list(batches())
    trainer = poff.OfflineTrainer(cfg, device="cpu")
    logs = []
    ckpt = str(tmp_path / "bc")
    state = trainer.fit(lambda: iter(fixed), val_batches=lambda: iter(fixed[:1]), num_epochs=2,
                        log_fn=lambda m, s: logs.append(m), output_dir=ckpt)
    assert state.epoch == 2 and state.step == 4 and [l["batches"] for l in logs] == [2, 2]
    assert logs[-1]["bc_loss"] < logs[0]["bc_loss"]
    assert "f1/macro" in logs[-1] and np.isfinite(logs[-1]["val_loss"])
    assert sorted(os.listdir(ckpt)) == ["step_2", "step_4"]

    trainer2 = poff.OfflineTrainer(cfg, device="cpu")
    resumed = trainer2.fit(lambda: iter(fixed), num_epochs=2, log_fn=lambda m, s: None, output_dir=ckpt)
    assert (resumed.epoch, resumed.step, resumed.opt_state.count) == (2, 4, 4)
    for a, b in zip(resumed.tower_params.values(), state.tower_params.values()):
        assert torch.equal(a, b)
    assert any(bool(m.abs().sum() > 0) for m in resumed.opt_state.mu)
    fresh = trainer2.restore_state(ckpt, restart_optimizer=True)
    assert fresh.opt_state.count == 0 and fresh.epoch == 2
    assert all(bool((m == 0).all()) and bool((n == 0).all()) for m, n in zip(fresh.opt_state.mu, fresh.opt_state.nu))

    agent_cfg = Config(dataclasses.replace(cfg.model))
    restored = pef.EarlyFusionCnnTransformer.build_agent(
        ckpt, cfg=agent_cfg, num_streams=2, device="cpu", test_augmentation=False
    )
    trainer.policy.requires_grad_(False)
    live = InferenceAgent(agent_cfg, trainer.policy, 2, test_augmentation=False)
    rng = np.random.default_rng(5)
    h, w = cfg.model.image_size
    for agent in (restored, live):
        agent.set_instructions(["find a mug", "go to the bed"])
    for t in range(3):
        frames = rng.integers(0, 256, (2, 2, h, w, 3), dtype=np.uint8)
        acts = [a.act(frames[0], frames[1], np.full(2, int(t > 0)), np.zeros(2, np.int32)) for a in (restored, live)]
        np.testing.assert_array_equal(acts[0], acts[1])
        np.testing.assert_array_equal(restored.last_probs, live.last_probs)


def test_cli_train_offline_writes_a_checkpoint(chores_dir, tiny_model_cfg, tmp_path, monkeypatch):
    from safevla_tpu_torch.cli import train_offline

    _register_test_tiny(monkeypatch)
    overrides = [f"model.{f.name}={getattr(tiny_model_cfg, f.name)}"
                 for f in dataclasses.fields(tiny_model_cfg)
                 if not isinstance(getattr(tiny_model_cfg, f.name), (tuple, list))]
    overrides += ["model.vision_grid=[7, 12]", "model.image_size=[28, 42]",
                  "model.dino_compressor_hidden_out_dims=[64, 64]",
                  "offline.num_epochs=1", "offline.per_device_batch_size=2", "offline.sliding_window=6",
                  f"train.output_dir={tmp_path}"]
    train_offline.main(["--data-dir", chores_dir] + overrides, device="cpu")
    steps = os.listdir(tmp_path / "offline")
    assert "step_2" in steps  # 4 episodes / batch 2 = 2 steps in the epoch
    assert os.path.isfile(tmp_path / "offline" / "step_2" / "train_state.pt")


def _prep_threads():
    import threading

    return [t for t in threading.enumerate() if t.name == "bc-batch-prep"]


def test_prepared_batches_thread_exits_when_abandoned(setup):
    """The consumer takes one batch of an endless stream and drops the
    generator: the worker thread stops (its queued batches are drained and
    freed) within a bounded wait; every yielded batch is host_prepare's."""
    import time

    mcfg, _, _, ptrainer, _, _ = setup
    hb = host_batch(mcfg, 2)

    def endless():
        while True:
            yield hb

    gen = ptrainer.prepared_batches(endless())
    first = next(gen)
    assert set(first) == {"rgb_nav", "rgb_manip", "last_actions", "actions", "time_ids",
                          "an_object_is_in_hand", "_text_tokens", "text_mask"}
    np.testing.assert_array_equal(first["rgb_nav"].numpy(), hb["rgb_nav"])
    gen.close()
    deadline = time.monotonic() + 10.0
    while _prep_threads() and time.monotonic() < deadline:
        time.sleep(0.05)
    assert not _prep_threads()


def test_prepared_batches_surface_a_worker_error(setup):
    """An error while reading or preparing a batch reaches the consumer after
    the batches before it."""
    mcfg, _, _, ptrainer, _, _ = setup

    def failing():
        yield host_batch(mcfg, 3)
        raise OSError("cannot read episode")

    got = []
    with pytest.raises(OSError, match="cannot read episode"):
        for pb in ptrainer.prepared_batches(failing()):
            got.append(pb)
    assert len(got) == 1
