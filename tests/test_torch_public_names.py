"""The port's counterparts of the JAX package's public names that it lacked
until the port covered every kernel (`tests/test_torch_isolation.py` walks
both packages), each held against JAX on the same numpy inputs: f32 within
1e-5, bf16 LayerNorm outputs within one bf16 ulp."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import safevla_tpu.config as jcfg
import safevla_tpu.constants as jconst
import safevla_tpu.models.llama_decoder as jdec
import safevla_tpu.ops.flash_attention as jfa
import safevla_tpu.ops.layer_norm as jln
import safevla_tpu.ops.masks as jmasks
import safevla_tpu.rollout.runner as jrunner
import safevla_tpu_torch.config as tcfg
import safevla_tpu_torch.constants as tconst
import safevla_tpu_torch.models.llama_decoder as tdec
import safevla_tpu_torch.native.obs_ring as tring
import safevla_tpu_torch.ops.flash_attention as tfa
import safevla_tpu_torch.ops.layer_norm as tln
import safevla_tpu_torch.ops.masks as tmasks
import safevla_tpu_torch.rollout.runner as trunner

ARGV = ["--fake-env", "preset=siglip_base", "train.task_type=FetchType", "model.critic_type=discrete",
        "train.num_train_processes=4", "output"]


def test_config_from_cli_and_asdict_match_jax():
    want = jcfg.asdict(jcfg.config_from_cli(ARGV))
    got = tcfg.asdict(tcfg.config_from_cli(ARGV))
    assert got == want
    assert got["model"]["critic_type"] == "discrete" and got["train"]["num_train_processes"] == 4
    assert tcfg.asdict(tcfg.Config()) == dataclasses.asdict(tcfg.Config())


def test_constants_match_jax():
    names = [n for n in dir(jconst) if n.isupper()]
    assert {"STRETCH_ACTION_LONG_NAMES", "NAV_ACTIONS", "NON_NAV_ACTION_INDS", "ROBOT_ACTION_MAPPING",
            "MAXIMUM_DISTANCE_ARM_FROM_AGENT_CENTER", "INTEL_WIDTH_CROPPED"} <= set(names)
    for name in names:
        assert getattr(tconst, name) == getattr(jconst, name), name
    assert set(tconst.ROBOT_ACTION_MAPPING) == set(tconst.ALL_STRETCH_ACTIONS)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_additive_matches_jax(dtype):
    mask = np.random.default_rng(0).random((2, 1, 5, 7)) < 0.5
    want = np.asarray(jmasks.additive(jnp.asarray(mask), getattr(jnp, dtype)).astype(jnp.float32))
    got = tmasks.additive(torch.from_numpy(mask), getattr(torch, dtype))
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(got.float().numpy(), want)


def _ln_inputs(r, d, seed=0):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((r, d)) * 2 + 0.5).astype(np.float32)
    gamma = (1 + 0.1 * rng.standard_normal(d)).astype(np.float32)
    beta = (0.1 * rng.standard_normal(d)).astype(np.float32)
    g = rng.standard_normal((r, d)).astype(np.float32)
    return x, gamma, beta, g


@pytest.mark.parametrize("r,d", [(37, 128), (16, 256)])
def test_layer_norm_rows_and_its_vjp_match_jax_in_f32(r, d):
    x, gamma, beta, g = _ln_inputs(r, d)
    want, vjp = jax.vjp(lambda *a: jln.layer_norm_rows(*a, 1e-6, None, True),
                        jnp.asarray(x), jnp.asarray(gamma), jnp.asarray(beta))
    want_grads = vjp(jnp.asarray(g))
    xt, gt, bt = (torch.from_numpy(a).requires_grad_(True) for a in (x, gamma, beta))
    got = tln.layer_norm_rows(xt, gt, bt)
    grads = torch.autograd.grad(got, (xt, gt, bt), torch.from_numpy(g))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-5)
    for mine, theirs in zip(grads, want_grads):
        np.testing.assert_allclose(mine.numpy(), np.asarray(theirs), atol=1e-5 * max(1, np.abs(theirs).max()))


def test_layer_norm_rows_bf16_within_one_ulp_of_jax():
    x, gamma, beta, _ = _ln_inputs(24, 128, seed=1)
    xb = np.array(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
    want = np.asarray(jln.layer_norm_rows(jnp.asarray(xb, jnp.bfloat16), jnp.asarray(gamma), jnp.asarray(beta),
                                          1e-6, None, True).astype(jnp.float32))
    got = tln.layer_norm_rows(torch.from_numpy(xb).bfloat16(), torch.from_numpy(gamma), torch.from_numpy(beta))
    assert got.dtype == torch.bfloat16
    assert np.all(np.abs(got.float().numpy() - want) <= 2.0**-7 * np.abs(want) + 1e-3)


def test_layer_norm_rows_takes_rows_of_128_lanes_only():
    for shape in [(2, 3, 128), (4, 64)]:
        with pytest.raises(ValueError, match="multiple of 128"):
            tln.layer_norm_rows(torch.zeros(shape), torch.ones(shape[-1]), torch.zeros(shape[-1]))


def _qkv(b, s, h, dh, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, s, h, dh)).astype(np.float32) for _ in range(3)]


KEY_LENS = np.asarray([40, 23, 1], np.int32)


@pytest.mark.parametrize("key_lens", [None, KEY_LENS])
def test_flash_attention_and_its_gradient_match_jax(key_lens):
    q, k, v = _qkv(3, 40, 2, 64)
    g = np.random.default_rng(1).standard_normal(q.shape).astype(np.float32)
    kl_j = None if key_lens is None else jnp.asarray(key_lens)
    want = jfa.flash_attention(*map(jnp.asarray, (q, k, v)), interpret=True, key_lens=kl_j)
    _, vjp = jax.vjp(lambda a, b_, c: jfa.attention(a, b_, c, interpret=True, key_lens=kl_j),
                     *map(jnp.asarray, (q, k, v)))
    want_grads = vjp(jnp.asarray(g))
    ts = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    kl_t = None if key_lens is None else torch.from_numpy(key_lens)
    got = tfa.flash_attention(*ts, kl_t)
    assert got.shape == q.shape
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-5)
    grads = torch.autograd.grad(got, ts, torch.from_numpy(g))
    for mine, theirs in zip(grads, want_grads):
        np.testing.assert_allclose(mine.numpy(), np.asarray(theirs), atol=1e-5)


@pytest.mark.parametrize(
    "h,dh,use,mask_kind",
    [
        (2, 64, True, "lens"),  # the kernel's function (JAX: Pallas, interpret mode)
        (2, 64, True, "mask"),  # an arbitrary mask: the dense path in both
        (2, 64, False, "lens"),  # the dense path asked for
        (2, 16, True, "lens"),  # 32 lanes: JAX takes XLA, the port dense_attention
    ],
)
def test_attention_dispatch_matches_jax(h, dh, use, mask_kind):
    q, k, v = _qkv(3, 40, h, dh, seed=2)
    rng = np.random.default_rng(3)
    mask = rng.random((3, 40)) < 0.7
    mask[:, 0] = True
    kw_j = {"key_lens": jnp.asarray(KEY_LENS)} if mask_kind == "lens" else {"key_mask": jnp.asarray(mask)}
    kw_t = {"key_lens": torch.from_numpy(KEY_LENS)} if mask_kind == "lens" else {"key_mask": torch.from_numpy(mask)}
    want = jfa.attention(*map(jnp.asarray, (q, k, v)), use_pallas=use, interpret=True, **kw_j)
    got = tfa.attention(*map(torch.from_numpy, (q, k, v)), use_kernel=use, **kw_t)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_attention_takes_one_form_of_mask():
    q, k, v = (torch.from_numpy(a) for a in _qkv(3, 40, 2, 64))
    with pytest.raises(ValueError, match="not both"):
        tfa.attention(q, k, v, key_mask=torch.ones(3, 40, dtype=torch.bool), key_lens=torch.from_numpy(KEY_LENS))


def test_kv_cache_init_and_gather_match_jax():
    cfg_j = jdec.DecoderConfig(dim=64, n_layers=2, n_heads=4, max_seq_len=6, dtype=jnp.float32)
    cfg_t = tdec.DecoderConfig(dim=64, n_layers=2, n_heads=4, max_seq_len=6, dtype=torch.float32)
    want = jdec.init_kv_cache(cfg_j, 5)
    got = tdec.init_kv_cache(cfg_t, 5)
    for name in ("k", "v"):
        assert tuple(got[name].shape) == want[name].shape == (2, 5, 6, 4, 16)
        assert not got[name].any()
    assert tdec.init_kv_cache(cfg_t, 5, dtype=torch.bfloat16)["k"].dtype == torch.bfloat16
    rng = np.random.default_rng(4)
    cache = {name: rng.standard_normal((2, 5, 6, 4, 16)).astype(np.float32) for name in ("k", "v")}
    keep = np.asarray([4, 0, 0, 2])
    want = jdec.gather_cache({n: jnp.asarray(c) for n, c in cache.items()}, jnp.asarray(keep))
    got = tdec.gather_cache({n: torch.from_numpy(c) for n, c in cache.items()}, torch.from_numpy(keep))
    for name in ("k", "v"):
        np.testing.assert_array_equal(got[name].numpy(), np.asarray(want[name]))


def test_native_available(monkeypatch):
    assert tring.native_available() is True  # g++ builds the ring here
    monkeypatch.setattr(tring, "_load", lambda: (_ for _ in ()).throw(RuntimeError("g++ not found")))
    assert tring.native_available() is False


def test_get_slot_matches_jax():
    rng = np.random.default_rng(5)
    frames = [rng.integers(0, 256, (4, 6, 3), dtype=np.uint8) for _ in range(4)]
    seq = [frames[i] for i in (0, 1, 0, 2, 3, 1, 0, 2)]  # 3 slots: evictions and hits
    want_bank = jrunner.DeviceFrameBank(3, (4, 6, 3))
    got_bank = trunner.DeviceFrameBank(3, (4, 6, 3), torch.device("cpu"))
    want = [want_bank.get_slot(f) for f in seq]
    got = [got_bank.get_slot(f) for f in seq]
    assert got == want and all(isinstance(s, int) for s in got)
    assert (got_bank.hits, got_bank.misses) == (want_bank.hits, want_bank.misses)
    np.testing.assert_array_equal(got_bank.bank.numpy(), np.asarray(want_bank.bank))
