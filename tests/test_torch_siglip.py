"""The secondary encoders through the policy and its entry points, on the CPU.

A tiny SigLIP-style policy (a patch-only ViT, no CLS, no LayerScale, and
the SigLIP text tower, `text_backbone=siglip_base`) and a tiny CLIP-style
one (CLIP's ResNet at width 8, layers (1, 1, 1, 1), 256 channels into the
compressor), each registered in both packages' registries (as
tests/test_siglip.py registers its tiny ViT), f32 on both sides, numpy-seeded
weights carried by `load_jax_params`:

* the agents' acts (tests/test_torch_serving_slice.py's drive: the text
  tower on the hash tokenizer's ids, some of them past its 32000 rows, the
  frozen encoder on augmented uint8 frames, the towers with their KV cache,
  across a reset) and `forward_seq` against JAX's, atol 1e-4; one
  `Learner.update` moves the towers and leaves the frozen encoders;
  `OfflineTrainer.fit` (one tower) writes a checkpoint that
  `EarlyFusionCnnTransformer.build_agent` restores bit-equal;
* `preset=siglip_base` gives JAX's model config, explicit overrides win,
  and the text tower takes JAX's head rule;
* `cli.train_online.main(["--fake-env", "preset=siglip_base", <tiny
  widths>], device="cpu")` trains 2 sync windows and writes a checkpoint,
  `cli.evaluate.main` restores it (frozen encoders included) and evaluates;
  restoring it into a policy of another backbone raises, the policy
  untouched."""

import dataclasses
import functools
import gzip
import json
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_tiny as tiny
from safevla_tpu.config import Config as JaxConfig
from safevla_tpu.config import apply_overrides as jax_apply_overrides
from safevla_tpu.evaluation.agent import InferenceAgent as JaxAgent
from safevla_tpu.models import actor_critic as jac
from safevla_tpu.models import resnet as jres
from safevla_tpu.models import t5 as jt5
from safevla_tpu.models import text_towers as jtt
from safevla_tpu.models import vit as jvit
from safevla_tpu.preprocessing.augment import AugmentParams as JaxAugmentParams
from safevla_tpu_torch.algo.learner import Learner
from safevla_tpu_torch.cli import evaluate as eval_cli
from safevla_tpu_torch.cli import train_online
from safevla_tpu_torch.config import Config, ModelConfig, TrainConfig, apply_overrides
from safevla_tpu_torch.envs.fake_controller import FakeController
from safevla_tpu_torch.evaluation import types as ptypes
from safevla_tpu_torch.evaluation.agent import InferenceAgent
from safevla_tpu_torch.models import actor_critic as pac
from safevla_tpu_torch.models.early_fusion import EarlyFusionCnnTransformer
from safevla_tpu_torch.models import resnet as pres
from safevla_tpu_torch.models import t5 as pt5
from safevla_tpu_torch.models import text_towers as ptt
from safevla_tpu_torch.models import vit as pvit
from safevla_tpu_torch.preprocessing.tokenize import InstructionTokenizer
from safevla_tpu_torch.training.offline import OfflineTrainer
from safevla_tpu_torch.utils.checkpoint import restore_policy_params

SIGLIP_VIT = "torch_siglip_tiny_f32"
SIGLIP_KW = dict(patch_size=14, embed_dim=32, depth=1, num_heads=2, img_height=28, img_width=42,
                 layerscale=False, use_cls_token=False)
RESNET = "torch_clip_rn_tiny_f32"
RESNET_KW = dict(width=8, layers=(1, 1, 1, 1))
B, STEPS, MAX_STEPS = 3, 5, 8
# "green", "stove" and "right" hash to ids >= 32000, past the text tower's rows
INSTRUCTIONS = ["go to the green mug", "find a vase", "find the stove on the right"]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    yield from tiny.one_torch_thread()


def register(monkeypatch):
    """The tiny encoders in both packages' registries, and the text towers
    (SigLIP's, T5) in f32 on both sides, as tests/test_torch_serving_slice.py
    switches the T5."""
    monkeypatch.setitem(jvit.VIT_CONFIGS, SIGLIP_VIT, jvit.DinoViTConfig(dtype=jnp.float32, **SIGLIP_KW))
    monkeypatch.setitem(pvit.VIT_CONFIGS, SIGLIP_VIT, pvit.DinoViTConfig(dtype=torch.float32, **SIGLIP_KW))
    monkeypatch.setitem(jres.RESNET_CONFIGS, RESNET, jres.ClipResNetConfig(dtype=jnp.float32, **RESNET_KW))
    monkeypatch.setitem(pres.RESNET_CONFIGS, RESNET, pres.ClipResNetConfig(dtype=torch.float32, **RESNET_KW))
    monkeypatch.setattr(jtt, "TextTowerConfig", functools.partial(jtt.TextTowerConfig, dtype=jnp.float32))
    monkeypatch.setattr(pac, "TextTowerConfig", functools.partial(ptt.TextTowerConfig, dtype=torch.float32))
    monkeypatch.setattr(jac, "T5Config", functools.partial(jt5.T5Config, dtype=jnp.float32))
    monkeypatch.setattr(pac, "T5Config", functools.partial(pt5.T5Config, dtype=torch.float32))


@pytest.fixture(autouse=True)
def _registered(monkeypatch):
    register(monkeypatch)


def model_cfg(tiny_model_cfg, backbone):
    """The conftest tiny config (3 fusion layers, fusion_chunk 8) with the
    SigLIP ViT + text tower, or CLIP's ResNet at 64x96 (a (2, 3) map pooled
    to (7, 12)) and the T5."""
    cfg = dataclasses.replace(tiny.model_cfg(tiny_model_cfg), max_steps=MAX_STEPS)
    if backbone == "siglip":
        return dataclasses.replace(cfg, vision_backbone=SIGLIP_VIT, text_backbone="siglip_base")
    return dataclasses.replace(cfg, vision_backbone=RESNET, vision_feature_dim=256, image_size=(64, 96))


def carried(mcfg, seed):
    """JAX policy, its numpy weights (BatchNorm variances positive) and the port policy."""
    jpol = jac.SafeVLAPolicy(mcfg)
    params = tiny.random_params(jpol, seed=seed)
    params = jax.tree_util.tree_map_with_path(
        lambda p, x: np.float32(1.0) + np.abs(x) if str(p[-1].key) == "var" else x, params
    )
    return jpol, params, tiny.port_policy(mcfg, params)


@pytest.mark.parametrize("backbone", ["siglip", "clip"])
def test_agent_acts_match_jax(tiny_model_cfg, backbone, monkeypatch):
    monkeypatch.setenv("SAFEVLA_AUGMENT_F32", "1")
    mcfg = model_cfg(tiny_model_cfg, backbone)
    _, params, policy = carried(mcfg, seed=11)
    jcfg = JaxConfig()
    jcfg.model = mcfg
    jcfg.train.max_steps = MAX_STEPS
    pcfg = Config(ModelConfig(**dataclasses.asdict(mcfg)), TrainConfig(max_steps=MAX_STEPS))
    jagent = JaxAgent(jcfg, jax.tree.map(jnp.asarray, params), num_streams=B, seed=123)
    agent = InferenceAgent(pcfg, policy, num_streams=B, seed=123)
    outs = {}
    step = agent._step

    def spy(*a):
        outs["step"] = step(*a)
        return outs["step"]

    monkeypatch.setattr(agent, "_step", spy)

    for a in (jagent, agent):
        a.set_instructions(INSTRUCTIONS)
    if backbone == "siglip":  # the hash tokenizer's ids reach past the tower's 32000 rows
        tokens, _ = InstructionTokenizer("siglip_base", mcfg.text_max_tokens).encode_batch(INSTRUCTIONS)
        assert tokens.max() >= policy.t5.cfg.vocab_size
    np.testing.assert_allclose(agent.state.text_hidden.numpy(), np.asarray(jagent.state.text_hidden), atol=1e-4)

    rng = np.random.default_rng(0)
    h, w = mcfg.image_size
    jprev = np.zeros(B, np.int32)
    for t in range(STEPS):
        not_reset = np.full(B, int(t > 0), np.int32)
        if t == 3:  # stream 1 starts a new episode with a new instruction
            not_reset[1] = 0
            agent.reset_streams(not_reset == 0)
            jprev[not_reset == 0] = 0
            for a in (jagent, agent):
                a.set_instructions([None, "navigate to the bed", None])
        nav, manip = (rng.integers(0, 256, (B, h, w, 3), dtype=np.uint8) for _ in range(2))
        oih = rng.integers(0, 3, B).astype(np.int32)
        actions = agent.act(nav, manip, not_reset, oih)
        aug = JaxAugmentParams(*[jnp.float32(v) for v in agent.aug_params])
        jaction, jprobs, jv, jcv, jagent.state = jagent._step_impl(
            jagent.params, jagent.state, aug, jnp.asarray(np.concatenate([nav, manip])),
            jnp.asarray(np.stack([jprev, not_reset, oih]).astype(np.int32)), jax.random.PRNGKey(t),
        )
        jprev = np.asarray(jaction).astype(np.int32)
        _, probs, v, cv, _ = outs["step"]
        np.testing.assert_allclose(torch.log(probs).numpy(), np.log(np.asarray(jprobs)), atol=1e-4)
        np.testing.assert_allclose(v.numpy(), np.asarray(jv), atol=1e-4)
        np.testing.assert_allclose(cv.numpy(), np.asarray(jcv), atol=1e-4)
        np.testing.assert_array_equal(actions, jprev)


@pytest.mark.parametrize("backbone", ["siglip", "clip"])
def test_forward_seq_matches_jax(tiny_model_cfg, backbone):
    mcfg = model_cfg(tiny_model_cfg, backbone)
    jpol, params, policy = carried(mcfg, seed=12)
    batch = tiny.rollout_batch(mcfg, seed=13)
    keys = ("dino_nav", "dino_manip", "text_hidden", "text_mask", "prev_actions", "not_reset",
            "object_in_hand", "time_step", "traj_idx", "text_idx")
    names = ("logits", "values", "c_values", "stop_grad_values")
    run = lambda p, *a: {n: getattr(jpol.forward_seq(p, *a), n) for n in names}
    want = jax.jit(run)(jax.tree.map(jnp.asarray, params), *(jnp.asarray(batch[k]) for k in keys))
    with torch.no_grad():
        got = policy.forward_seq(*(torch.from_numpy(batch[k]) for k in keys))
    for name in names:
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(want[name]), atol=1e-4, err_msg=name)


@pytest.mark.parametrize("backbone", ["siglip", "clip"])
def test_learner_updates_the_towers_and_not_the_frozen_encoders(tiny_model_cfg, backbone):
    """One Learner.update (stage 1) of the port's policy with each secondary
    encoder: finite metrics, every tower moved, the frozen encoders' weights
    (ViT or ResNet, SigLIP text tower or T5) left as they were."""
    mcfg = model_cfg(tiny_model_cfg, backbone)
    _, _, policy = carried(mcfg, seed=14)
    frozen = {k: v.clone() for k, v in [*policy.vit.state_dict().items(), *policy.t5.state_dict().items()]}
    learner = Learner(policy, Config(ModelConfig(**dataclasses.asdict(mcfg)), TrainConfig(max_steps=MAX_STEPS)))
    ts = learner.init()
    before = {k: p.detach().clone() for k, p in ts.tower_params.items()}
    ts, metrics = learner.update(ts, tiny.rollout_batch(mcfg, seed=15), 3.0, 1)
    assert all(np.isfinite(float(v)) for v in metrics.values()), metrics
    for t in range(mcfg.num_towers):
        assert any(not torch.equal(p, before[k]) for k, p in ts.tower_params.items() if k.startswith(f"{t}."))
    after = {**policy.vit.state_dict(), **policy.t5.state_dict()}
    assert all(torch.equal(after[k], v) for k, v in frozen.items())


@pytest.mark.parametrize("backbone", ["siglip", "clip"])
def test_offline_fit_and_restore(tiny_model_cfg, backbone, tmp_path):
    """OfflineTrainer with one tower fits an epoch (the frozen encoder on
    every frame of the batch, its BCTrainState carrying it as "vit" / "t5"),
    and `EarlyFusionCnnTransformer.build_agent` from the checkpoint acts
    bit-equal to the trained policy."""
    mcfg = dataclasses.replace(model_cfg(tiny_model_cfg, backbone), num_towers=1)
    cfg = Config(ModelConfig(**dataclasses.asdict(mcfg)), TrainConfig(max_steps=MAX_STEPS))
    trainer = OfflineTrainer(cfg, device="cpu")
    h, w = mcfg.image_size
    rng = np.random.default_rng(16)
    host = {
        "rgb_nav": rng.integers(0, 255, (2, 4, h, w, 3), dtype=np.uint8),
        "rgb_manip": rng.integers(0, 255, (2, 4, h, w, 3), dtype=np.uint8),
        "last_actions": rng.integers(0, mcfg.num_actions, (2, 4)).astype(np.int32),
        "actions": rng.integers(0, mcfg.num_actions, (2, 4)).astype(np.int32),
        "time_ids": np.tile(np.arange(4, dtype=np.int32), (2, 1)),
        "an_object_is_in_hand": np.zeros((2, 4), np.int32),
        "instructions": INSTRUCTIONS[1:],
    }
    state = trainer.fit(lambda: iter([host]), num_epochs=1, log_fn=lambda m, s: None, output_dir=str(tmp_path))
    assert state.step == 1 and set(state.frozen_params) == {"vit", "t5"}
    assert set(state.frozen_params["vit"]) == set(trainer.policy.vit.state_dict())
    trainer.policy.requires_grad_(False)
    agents = [InferenceAgent(cfg, trainer.policy, 2, test_augmentation=False),
              EarlyFusionCnnTransformer.build_agent(str(tmp_path), cfg=cfg, num_streams=2, device="cpu",
                                                    test_augmentation=False)]
    for t in range(2):
        out = []
        for a in agents:
            a.set_instructions(INSTRUCTIONS[:2])
            a.act(host["rgb_nav"][:, t], host["rgb_manip"][:, t], np.full(2, int(t > 0)), np.zeros(2, np.int32))
            out.append(a.last_probs)
        np.testing.assert_array_equal(out[0], out[1])


def test_siglip_preset_matches_jax():
    for extra in ([], ["model.text_max_tokens=16", "model.image_size=[224, 384]"]):
        got = apply_overrides(Config(), ["preset=siglip_base", *extra]).model
        want = jax_apply_overrides(JaxConfig(), ["preset=siglip_base", *extra]).model
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.text_max_tokens == 16 and got.image_size == (224, 384)  # explicit overrides win
    base = apply_overrides(Config(), ["preset=siglip_base"]).model
    assert (base.vision_backbone, base.vision_feature_dim, base.image_size) == ("siglip_vitb16_256", 768, (256, 256))
    assert (base.text_backbone, base.text_embed_size, base.text_max_tokens) == ("siglip_base", 768, 64)


@pytest.mark.parametrize("width", [36, 40, 64])
def test_text_tower_takes_jax_head_rule(tiny_model_cfg, width):
    mcfg = dataclasses.replace(model_cfg(tiny_model_cfg, "siglip"), text_embed_size=width)
    policy = pac.SafeVLAPolicy(ModelConfig(**dataclasses.asdict(mcfg)), device="cpu")
    want = jac.SafeVLAPolicy(mcfg).t5.cfg
    assert isinstance(policy.t5, ptt.SigLIPTextEncoder)
    got = policy.t5.cfg
    assert (got.d_model, got.num_heads, got.max_tokens, got.vocab_size, got.num_layers) == (
        want.d_model, want.num_heads, want.max_tokens, want.vocab_size, want.num_layers)
    assert policy.device == torch.device("cpu")


# `cli.train_online --fake-env preset=siglip_base` cut to the tiny widths
TINY_OVERRIDES = [
    "preset=siglip_base", f"model.vision_backbone={SIGLIP_VIT}", "model.vision_feature_dim=32",
    "model.image_size=[28, 42]", "model.text_embed_size=64", "model.text_max_tokens=8", "model.hidden_size=64",
    "model.num_tx_layers=2", "model.num_tx_heads=4", "model.goal_dims=64", "model.combiner_layers=2",
    "model.combiner_heads=4", "model.combiner_ffn_dim=128", "model.dino_compressor_hidden_out_dims=[64, 64]",
    "model.max_steps=16", "model.compute_dtype=float32", "train.max_steps=16", "train.num_train_processes=3",
    "ppo.num_steps=8", "train.async_pipeline=false",
]


@pytest.fixture(scope="module")
def siglip_run(tmp_path_factory):
    out = tmp_path_factory.mktemp("siglip_run")
    random.seed(0)
    np.random.seed(0)
    with pytest.MonkeyPatch.context() as mp:
        register(mp)
        ts = train_online.main(["--fake-env", *TINY_OVERRIDES, "train.total_steps=48",
                                f"train.output_dir={out}"], device="cpu")
    return out / Config().train.tag, ts


def test_train_online_and_evaluate_cli_with_siglip(siglip_run, tmp_path, monkeypatch):
    run_dir, ts = siglip_run
    assert ts.step == 48 and (run_dir / "step_48" / "train_state.pt").is_file()
    assert set(ts.frozen_params["t5"]) >= {"token_embedding.weight", "positional_embedding"}
    with open(run_dir / "metrics.jsonl") as f:
        logs = [json.loads(line) for line in f]
    assert [m["step"] for m in logs] == [24, 48]
    assert all(np.isfinite(v) for m in logs for v in m.values() if isinstance(v, float))

    # two ObjectNav rows on FakeController's objects, episodes of at most 12
    # steps (tests/test_torch_train_online.py's evaluation, cut to its size)
    target = FakeController(seed=0).get_objects()[0]
    synset = target["objectType"].lower() + ".n.01"
    ids = [target["objectId"]]
    bench = tmp_path / "objectnavtype_val.jsonl.gz"
    with gzip.open(bench, "wt") as f:
        for i in range(2):
            f.write(json.dumps({
                "task_type": "ObjectNavType", "house_index": 0,
                "natural_language_spec": f"find the {target['objectType'].lower()} on the right",
                "agent_starting_position": [1.5, 0.9, 3.0], "agent_y_rotation": float(90 * i),
                "expert_length": 10, "synsets": [synset], "synset_to_object_ids": {synset: ids},
                "broad_synset_to_object_ids": {synset: ids},
            }) + "\n")
    monkeypatch.setitem(ptypes.MAX_EPISODE_LEN_PER_TASK, "ObjectNavType", 12)
    results = eval_cli.main(
        ["--ckpt", str(run_dir), "--benchmark", str(bench), "--fake-env", *TINY_OVERRIDES,
         "eval.num_workers=2", "eval.test_augmentation=false", f"train.output_dir={tmp_path}"],
        device="cpu",
    )
    assert results["num_episodes"] == 2
    assert all(np.isfinite(v) for v in results["aggregate"].values())

    # the restored policy is the trained one, frozen encoders included
    cfg = apply_overrides(Config(), list(TINY_OVERRIDES))
    policy = restore_policy_params(str(run_dir), pac.SafeVLAPolicy(cfg.model, device="cpu"))
    for k, t in ts.frozen_params["t5"].items():
        torch.testing.assert_close(policy.t5.state_dict()[k], t, rtol=0, atol=0)
    for k, p in ts.tower_params.items():
        torch.testing.assert_close(policy.towers.state_dict()[k], p.detach(), rtol=0, atol=0)


@pytest.mark.parametrize("other", ["dinov2", "clip"])
def test_restore_into_another_backbone_raises(siglip_run, other, monkeypatch):
    run_dir, _ = siglip_run
    cfg = apply_overrides(Config(), list(TINY_OVERRIDES)).model
    if other == "dinov2":  # the same towers, another ViT and the T5
        tiny.register_tiny_vit(monkeypatch)
        cfg = dataclasses.replace(cfg, vision_backbone=tiny.VIT, text_backbone="t5-small")
    else:  # the ResNet's 256 channels: other tower widths too
        cfg = dataclasses.replace(cfg, vision_backbone=RESNET, vision_feature_dim=256, image_size=(64, 96))
    policy = pac.SafeVLAPolicy(cfg, device="cpu")
    before = {k: v.clone() for k, v in policy.state_dict().items()}
    with pytest.raises(ValueError, match="does not match the current model"):
        restore_policy_params(str(run_dir), policy)
    for k, v in policy.state_dict().items():  # nothing was loaded
        torch.testing.assert_close(v, before[k], rtol=0, atol=0)
