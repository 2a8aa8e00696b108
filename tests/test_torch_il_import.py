"""`il_ckpt_path` on the port's OnlineTrainer against the JAX package's
`models/convert.py::load_reference_checkpoint` on the same file, on the CPU.

The files are reference-layout torch checkpoints made from a tiny port
policy (another seed than the trainer's): an IL checkpoint (Lightning's
container, the actor tower alone, the actor head named `actor.weight`), and
an AllenAct RL checkpoint of all three towers. The trainer's towers after
`init_state()` must equal the JAX importer's towers exactly (atol 0), carried
to the port's names by `from_jax.tower_state_dict`.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import torch_port_tiny as tiny
from safevla_tpu.algo.learner import TrainState as JaxTrainState
from safevla_tpu.config import Config as JaxConfig
from safevla_tpu.models.convert import import_stacked_towers_from_torch, load_reference_checkpoint
from safevla_tpu_torch.config import Config, ModelConfig, TrainConfig
from safevla_tpu_torch.envs.fake_tasks import make_sampler_factory
from safevla_tpu_torch.models.actor_critic import SafeVLAPolicy
from safevla_tpu_torch.models.convert import TOWER_PREFIXES
from safevla_tpu_torch.models.from_jax import _unstack, tower_state_dict
from safevla_tpu_torch.training.online import OnlineTrainer


@pytest.mark.parametrize("layout", ["il_lightning", "allenact_three_towers"])
def test_il_ckpt_path_loads_the_towers_jax_loads(tiny_model_cfg, monkeypatch, tmp_path, layout):
    tiny.register_tiny_vit(monkeypatch)
    mcfg = tiny.model_cfg(tiny_model_cfg)
    pm = ModelConfig(**dataclasses.asdict(mcfg))
    src = SafeVLAPolicy(pm, device="cpu", generator=torch.Generator().manual_seed(21))
    towers = 1 if layout == "il_lightning" else 3
    sd = {}
    for (_, prefix), tower in zip(TOWER_PREFIXES[:towers], src.towers):
        sd.update({prefix + k: v for k, v in tower.state_dict().items()})
    path = str(tmp_path / "ref.ckpt")
    if layout == "il_lightning":
        il = lambda k: "actor." + k[len("actor.linear."):] if k.startswith("actor.linear.") else k
        torch.save({"state_dict": {"model." + il(k): v for k, v in sd.items()}}, path)
    else:
        torch.save({"model_state_dict": sd}, path)

    cfg = Config(pm, TrainConfig(num_train_processes=2, max_steps=pm.max_steps, output_dir=str(tmp_path),
                                 il_ckpt_path=path, async_pipeline=False))
    trainer = OnlineTrainer(cfg, make_sampler_factory(), num_workers=0, device="cpu")
    ts = trainer.init_state()
    trainer.close()

    jcfg = JaxConfig()
    jcfg.model = mcfg
    # the train state's towers only give load_reference_checkpoint their
    # shapes and dtypes: the JAX importer's own tree of the file serves
    template = jax.tree.map(np.zeros_like, import_stacked_towers_from_torch(path, cfg=mcfg, num_towers=3))
    jts = load_reference_checkpoint(path, JaxTrainState(template, None, None, None, 0), cfg=jcfg)
    want = {}
    for t in range(pm.num_towers):
        want.update({f"{t}.{k}": v for k, v in tower_state_dict(_unstack(jts.tower_params, t)).items()})
    assert ts.tower_params.keys() == want.keys()
    for k, v in want.items():
        np.testing.assert_array_equal(ts.tower_params[k].detach().numpy(), np.asarray(v), err_msg=k)
