"""`tools/torch_from_orbax.py`: a JAX Orbax checkpoint of the JAX package,
converted into the port's format, restores in the port to the weights
`load_jax_params` gives from the same tree (exactly), for a trainer state
(towers and frozen encoders) and for a bare params tree of towers alone
(whose ViT and T5 come from the JAX init passed in), through a run
directory of `step_<n>` children."""

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
