"""The port's torch checkpoint readers (`safevla_tpu_torch/models/convert.py`)
against the JAX package's (`safevla_tpu/models/convert.py`), on the CPU.

Reference-layout files are made from a tiny port policy's `state_dict()`
(its names are the reference's): the three containers (raw, AllenAct's
`model_state_dict`, Lightning's `state_dict` with `model.` prefixes and the
IL actor head named `actor.weight`), and an actor-only IL file. Both
packages read each; the JAX towers, carried to the port's names by
`from_jax.tower_state_dict`, must equal the port's loaded towers exactly
(atol 0). `interpolate_pos_embed` matches at atol 1e-5; `import_dinov2` and
`import_t5` on synthesised torch-hub / HF-named dicts match exactly.
"""

import dataclasses

import numpy as np
import pytest
import torch

import torch_port_tiny as tiny
from safevla_tpu.models import convert as jconvert
from safevla_tpu_torch.config import ModelConfig
from safevla_tpu_torch.models import convert
from safevla_tpu_torch.models.actor_critic import SafeVLAPolicy
from safevla_tpu_torch.models.from_jax import _unstack, t5_state_dict, tower_state_dict, vit_state_dict


@pytest.fixture
def mcfg(tiny_model_cfg, monkeypatch):
    tiny.register_tiny_vit(monkeypatch)
    return tiny.model_cfg(tiny_model_cfg)


def _policy(mcfg, seed):
    return SafeVLAPolicy(
        ModelConfig(**dataclasses.asdict(mcfg)), device="cpu", generator=torch.Generator().manual_seed(seed)
    )


def _reference_file(policy, container, path, towers=3):
    """A reference-layout torch file of the policy's towers."""
    sd = {}
    for (_, prefix), tower in zip(convert.TOWER_PREFIXES[:towers], policy.towers):
        sd.update({prefix + k: v.clone() for k, v in tower.state_dict().items()})
    if container == "raw":
        ckpt = sd
    elif container == "allenact":
        ckpt = {"model_state_dict": sd, "optimizer_state_dict": {}, "total_steps": 7}
    else:  # lightning, with the IL naming of the actor head
        ren = {(k.replace("actor.linear.", "actor.", 1) if k.startswith("actor.linear.") else k): v
               for k, v in sd.items()}
        ckpt = {"state_dict": {f"model.{k}": v for k, v in ren.items()}, "epoch": 3}
    torch.save(ckpt, path)
    return sd


def _jax_towers_as_port(stacked, n):
    return [{k: np.asarray(v) for k, v in tower_state_dict(_unstack(stacked, t)).items()} for t in range(n)]


@pytest.mark.parametrize("container", ["raw", "allenact", "lightning"])
def test_containers_load_as_the_jax_importer_reads_them(mcfg, tmp_path, container):
    src = _policy(mcfg, seed=1)
    path = tmp_path / "ref.pt"
    flat = _reference_file(src, container, path)
    ckpt = torch.load(path, weights_only=False)
    got, want = convert.normalize_reference_checkpoint(ckpt), jconvert.normalize_reference_checkpoint(ckpt)
    assert list(got) == list(want) == list(flat)
    assert all(got[k] is want[k] for k in got)
    split_got, split_want = convert.split_tower_state_dicts(got), jconvert.split_tower_state_dicts(want)
    assert {r: list(d) for r, d in split_got.items()} == {r: list(d) for r, d in split_want.items()}

    dst = _policy(mcfg, seed=2)
    convert.load_reference_towers(str(path), dst.towers)
    stacked = jconvert.import_stacked_towers_from_torch(str(path), cfg=mcfg, num_towers=3)
    for tower, want_sd in zip(dst.towers, _jax_towers_as_port(stacked, 3)):
        got_sd = tower.state_dict()
        assert got_sd.keys() == want_sd.keys()
        for k, v in want_sd.items():
            np.testing.assert_array_equal(got_sd[k].numpy(), v, err_msg=k)


def test_actor_only_file_fills_the_critics(mcfg, tmp_path):
    src = _policy(mcfg, seed=3)
    path = tmp_path / "il.ckpt"
    _reference_file(src, "lightning", path, towers=1)
    dst = _policy(mcfg, seed=4)
    convert.load_reference_towers(str(path), dst.towers)
    stacked = jconvert.import_stacked_towers_from_torch(str(path), cfg=mcfg, num_towers=3)
    actor = src.towers[0].state_dict()
    for tower, want_sd in zip(dst.towers, _jax_towers_as_port(stacked, 3)):
        for k, v in tower.state_dict().items():
            np.testing.assert_array_equal(v.numpy(), want_sd[k], err_msg=k)
            assert torch.equal(v, actor[k])


def test_a_missing_or_misshapen_parameter_raises(mcfg, tmp_path):
    src = _policy(mcfg, seed=5)
    sd = {k: v.clone() for k, v in src.towers[0].state_dict().items()}
    sd.pop("decoder.norm.weight")
    torch.save(sd, tmp_path / "missing.pt")
    with pytest.raises(ValueError, match="missing"):
        convert.load_reference_towers(str(tmp_path / "missing.pt"), src.towers)
    sd = {k: v.clone() for k, v in src.towers[0].state_dict().items()}
    sd["decoder.norm.weight"] = torch.ones(3)
    torch.save(sd, tmp_path / "shape.pt")
    with pytest.raises(ValueError, match="shape"):
        convert.load_reference_towers(str(tmp_path / "shape.pt"), src.towers)


def test_interpolate_pos_embed_matches_jax():
    rng = np.random.default_rng(0)
    pos = rng.standard_normal((1, 1 + 2 * 3, 24)).astype(np.float32)
    want = jconvert.interpolate_pos_embed(pos, (2, 3), (4, 5))
    got = convert.interpolate_pos_embed(torch.from_numpy(pos), (2, 3), (4, 5))
    assert got.shape == want.shape == (1, 21, 24)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


def test_import_dinov2_matches_jax(mcfg):
    """A torch-hub-named DINOv2 dict (a 4x4 source grid, and a hub key the
    importers do not read) -> the port's ViT state dict, as the JAX importer
    maps it; the port's ViT takes it whole."""
    policy = _policy(mcfg, seed=6)
    hub = {k: v.clone() for k, v in policy.vit.state_dict().items()}
    rng = np.random.default_rng(1)
    d = policy.vit.cfg.embed_dim
    hub["pos_embed"] = torch.from_numpy(rng.standard_normal((1, 1 + 16, d)).astype(np.float32))
    hub["mask_token"] = torch.zeros(1, d)
    depth, grid = policy.vit.cfg.depth, policy.vit.cfg.grid
    got = convert.import_dinov2(hub, depth=depth, grid=grid)
    want = vit_state_dict(jconvert.import_dinov2({k: v.float() for k, v in hub.items()}, depth=depth, grid=grid))
    assert got.keys() == want.keys()
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].float().numpy(), np.asarray(v, np.float32), err_msg=k)
    policy.vit.load_state_dict(got)  # exactly the ViT's keys
    assert torch.equal(policy.vit.pos_embed, got["pos_embed"])


def test_import_t5_matches_jax(mcfg):
    policy = _policy(mcfg, seed=7)
    hf = {k: v.clone() for k, v in policy.t5.state_dict().items()}
    hf["encoder.embed_tokens.weight"] = hf["shared.weight"]  # HF's tied copy, not read
    n = len(policy.t5.encoder.block)
    got = convert.import_t5(hf, num_layers=n)
    want = t5_state_dict(jconvert.import_t5({k: v.float() for k, v in hf.items()}, num_layers=n))
    assert got.keys() == want.keys()
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].float().numpy(), np.asarray(v, np.float32), err_msg=k)
    other = _policy(mcfg, seed=8)
    other.t5.load_state_dict(got)  # exactly the T5's keys
    assert all(torch.equal(a, b) for a, b in zip(other.t5.state_dict().values(), policy.t5.state_dict().values()))
