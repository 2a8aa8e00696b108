"""`tools/torch_from_orbax.py`: a JAX Orbax checkpoint of the JAX package,
converted into the port's format, restores in the port to the weights
`load_jax_params` gives from the same tree (exactly), for a trainer state
(towers and frozen encoders) and for a bare params tree of towers alone
(whose ViT and T5 come from the JAX init passed in), through a run
directory of `step_<n>` children; and a JAX behaviour-cloning checkpoint
(`OfflineTrainer.fit` with one tower) read through the port's
`EarlyFusionCnnTransformer.build_agent`."""

import dataclasses
import importlib.util
import os

import jax
import numpy as np
import pytest
import torch

import torch_port_tiny as tiny
from safevla_tpu.algo.learner import TrainState as JaxTrainState
from safevla_tpu.models import actor_critic as jac
from safevla_tpu.utils.checkpoint import save_checkpoint as jax_save
from safevla_tpu_torch.config import Config, ModelConfig, TrainConfig
from safevla_tpu_torch.evaluation.agent import InferenceAgent
from safevla_tpu_torch.models.actor_critic import SafeVLAPolicy
from safevla_tpu_torch.models.from_jax import load_jax_params

_TOOL = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tools", "torch_from_orbax.py")


def _tool():
    spec = importlib.util.spec_from_file_location("torch_from_orbax", _TOOL)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def trees(tiny_model_cfg):
    """The tiny policy's config and two weight trees of the JAX policy (the
    saved one and the init), made once for the module."""
    with pytest.MonkeyPatch.context() as mp:
        tiny.register_tiny_vit(mp)
        mcfg = tiny.model_cfg(tiny_model_cfg)
        jpol = jac.SafeVLAPolicy(mcfg)
        yield mcfg, tiny.random_params(jpol, seed=5), tiny.random_params(jpol, seed=6)


@pytest.mark.parametrize("layout", ["trainer_state", "bare_towers"])
def test_orbax_round_trip(trees, monkeypatch, tmp_path, layout):
    tiny.register_tiny_vit(monkeypatch)
    mcfg, saved, init = trees
    if layout == "trainer_state":
        tree = JaxTrainState(saved["towers"], {"vit": saved["vit"], "t5": saved["t5"]}, {}, {}, np.int64(9))
        want = saved
    else:
        tree = {"towers": saved["towers"]}
        want = {**init, "towers": saved["towers"]}
    jax_save(str(tmp_path / "orbax"), tree, 9)

    out = _tool().convert(str(tmp_path / "orbax"), str(tmp_path / "port"), model_cfg=mcfg, init_params=init)
    assert out == str(tmp_path / "port" / "step_9")

    pm = ModelConfig(**dataclasses.asdict(mcfg))
    agent = InferenceAgent.build(Config(pm, TrainConfig(max_steps=pm.max_steps)), str(tmp_path / "port"),
                                 num_streams=1, device="cpu")
    ref = load_jax_params(SafeVLAPolicy(pm, device="cpu"), jax.device_get(want)).state_dict()
    got = agent.policy.state_dict()
    assert got.keys() == ref.keys()
    for k, v in ref.items():
        assert torch.equal(got[k], v), k


def test_jax_bc_checkpoint_into_the_port(tiny_model_cfg, monkeypatch, tmp_path):
    """One epoch of the JAX OfflineTrainer at the tiny config with one tower
    (one batch: one step) writes an Orbax BCTrainState; the tool converts it
    with the tool unchanged, and the port's EarlyFusionCnnTransformer.build_agent
    restores towers equal to the JAX state's (and its ViT and T5)."""
    import jax.numpy as jnp

    from safevla_tpu.config import Config as JaxConfig
    from safevla_tpu.training.offline import OfflineTrainer as JaxOfflineTrainer
    from safevla_tpu_torch.models.early_fusion import EarlyFusionCnnTransformer

    tiny.register_tiny_vit(monkeypatch)
    mcfg = dataclasses.replace(tiny.model_cfg(tiny_model_cfg), num_towers=1)
    init = tiny.random_params(jac.SafeVLAPolicy(mcfg), seed=7)
    jcfg = JaxConfig()
    jcfg.model = mcfg
    jcfg.train.use_data_augmentation = False
    trainer = JaxOfflineTrainer(jcfg)
    monkeypatch.setattr(trainer.policy, "init_params", lambda rng, text_len=None: jax.tree.map(jnp.asarray, init))
    rng = np.random.default_rng(8)
    b, t = 2, 4
    h, w = mcfg.image_size
    batch = {
        "rgb_nav": rng.integers(0, 256, (b, t, h, w, 3), dtype=np.uint8),
        "rgb_manip": rng.integers(0, 256, (b, t, h, w, 3), dtype=np.uint8),
        "last_actions": rng.integers(0, mcfg.num_actions, (b, t)).astype(np.int32),
        "actions": rng.integers(0, mcfg.num_actions, (b, t)).astype(np.int32),
        "time_ids": np.tile(np.arange(t, dtype=np.int32), (b, 1)),
        "an_object_is_in_hand": np.zeros((b, t), np.int32),
        "instructions": ["find a mug", "go to the bed"],
    }
    state = trainer.fit(lambda: iter([batch]), num_epochs=1, log_fn=lambda m, s: None,
                        output_dir=str(tmp_path / "orbax"))
    assert int(state.step) == 1 and os.path.isdir(tmp_path / "orbax" / "step_1")

    out = _tool().convert(str(tmp_path / "orbax"), str(tmp_path / "port"), model_cfg=mcfg, init_params=init)
    assert out == str(tmp_path / "port" / "step_1")
    pm = ModelConfig(**dataclasses.asdict(mcfg))
    agent = EarlyFusionCnnTransformer.build_agent(
        str(tmp_path / "port"), cfg=Config(pm, TrainConfig(max_steps=pm.max_steps)), device="cpu"
    )
    want_tree = {"towers": state.tower_params, **state.frozen_params}
    ref = load_jax_params(SafeVLAPolicy(pm, device="cpu"), jax.device_get(want_tree)).state_dict()
    got = agent.policy.state_dict()
    assert got.keys() == ref.keys() and agent.policy.num_towers == 1
    for k, v in ref.items():
        assert torch.equal(got[k], v), k
    # the step moved the towers: the agent holds the trained weights, not the init
    moved = load_jax_params(SafeVLAPolicy(pm, device="cpu"), jax.device_get(init)).state_dict()
    assert any(not torch.equal(got[k], moved[k]) for k in got if k.startswith("towers."))
