"""The port's attention backward vs the JAX Pallas `_bwd_kernel` on the CPU.

`attention_qkv_bwd_reference` is the CPU stand-in of
`csrc/flash_attention_bwd.cu`; it must match `_flash_attention_qkv_bwd(...,
interpret=True)`, the TPU kernel's own body, which needs H*Dh a multiple of
128 (H=2, Dh=64 here). Tolerances: f32 atol 1e-5 (sum order only); bf16
atol 1e-2 (one bf16 ulp of gradients of magnitude < 2 is 2^-7 ~ 0.008, where
a rounding point of p or ds falls the other way).

Also the autograd Function `attention_qkv` goes through when a gradient is
taken: its gradients against torch.autograd through a plain f32 softmax
attention, and under `torch.utils.checkpoint`, at atol 1e-5.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.checkpoint import checkpoint

from safevla_tpu.ops.flash_attention import _flash_attention_qkv_bwd
from safevla_tpu_torch.ops import flash_attention as port

H, DH = 2, 64


def _inputs(b, s, seed):
    rng = np.random.default_rng(seed)
    qkv = rng.standard_normal((b, s, 3 * H * DH), dtype=np.float32)
    g = rng.standard_normal((b, s, H * DH), dtype=np.float32)
    return qkv, g


def _jax_bwd(qkv, g, kl, dtype):
    return np.asarray(
        _flash_attention_qkv_bwd(
            jnp.asarray(qkv, dtype), H, None if kl is None else jnp.asarray(kl),
            jnp.asarray(g, dtype), interpret=True,
        ),
        np.float32,
    )


@pytest.mark.parametrize(
    "b,s,key_lens,dtype,atol",
    [
        (2, 208, [169, 201], "float32", 1e-5),  # the update's fusion shape, ragged text
        (3, 64, None, "float32", 1e-5),
        (2, 208, [169, 201], "bfloat16", 1e-2),
        (3, 64, None, "bfloat16", 1e-2),
        # the edges of the card kernel's tiles: one valid key and all S,
        # S = 65, key counts on tile borders, one batch row. One valid key
        # makes dv the sum of g over all S rows (|dv| ~ sqrt(S)), so it is
        # held to the absolute 1e-5 at S = 65, where that sum stays small
        (2, 65, [1, 65], "float32", 1e-5),
        (3, 201, [64, 128, 201], "float32", 1e-5),
        (1, 208, [208], "float32", 1e-5),
    ],
)
def test_bwd_reference_matches_pallas_interpret(b, s, key_lens, dtype, atol):
    qkv, g = _inputs(b, s, seed=s + b)
    kl = None if key_lens is None else np.asarray(key_lens, np.int32)
    want = _jax_bwd(qkv, g, kl, getattr(jnp, dtype))
    tdt = getattr(torch, dtype)
    got = port.attention_qkv_bwd(
        torch.from_numpy(qkv).to(tdt), H, None if kl is None else torch.from_numpy(kl),
        torch.from_numpy(g).to(tdt),
    )
    assert got.dtype == tdt and got.shape == (b, s, 3 * H * DH)
    np.testing.assert_allclose(got.float().numpy(), want, atol=atol)


def test_masked_keys_get_exactly_zero_dk_dv():
    qkv, g = _inputs(2, 48, seed=1)
    kl = torch.tensor([20, 48], dtype=torch.int32)
    d = port.attention_qkv_bwd(torch.from_numpy(qkv), H, kl, torch.from_numpy(g))
    lanes = H * DH
    assert torch.all(d[0, 20:, lanes:] == 0)
    assert torch.all(d[0, :20, lanes:] != 0)


def _softmax_attention_f32(qkv, heads, key_lens):
    """Independent plain attention, differentiated by torch.autograd."""
    b, s, three = qkv.shape
    dh = three // 3 // heads
    q, k, v = qkv.reshape(b, s, 3, heads, dh).unbind(2)
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(dh)
    mask = torch.arange(s)[None, :] < key_lens[:, None]
    p = torch.softmax(logits.masked_fill(~mask[:, None, None, :], -1e30), dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v).reshape(b, s, heads * dh)


@pytest.mark.parametrize("use_checkpoint", [False, True])
def test_autograd_function_matches_autograd_through_softmax(use_checkpoint):
    qkv_np, g_np = _inputs(3, 40, seed=2)
    kl = torch.tensor([40, 17, 1], dtype=torch.int32)
    g = torch.from_numpy(g_np)
    grads = []
    for fn in (port.attention_qkv, _softmax_attention_f32):
        qkv = torch.from_numpy(qkv_np).requires_grad_(True)
        if use_checkpoint:
            out = checkpoint(fn, qkv, H, kl, use_reentrant=False)
        else:
            out = fn(qkv, H, kl)
        (out * g).sum().backward()
        grads.append(qkv.grad)
    torch.testing.assert_close(grads[0], grads[1], rtol=0, atol=1e-5)


def test_grad_path_only_when_a_gradient_is_taken():
    qkv = torch.from_numpy(_inputs(2, 16, seed=3)[0]).requires_grad_(True)
    assert port.attention_qkv(qkv, H).grad_fn is not None
    with torch.no_grad():
        assert port.attention_qkv(qkv, H).grad_fn is None
    before = (port.attention_qkv.launches, port.attention_qkv_bwd.launches)
    port.attention_qkv(qkv, H).sum().backward()
    assert (port.attention_qkv.launches, port.attention_qkv_bwd.launches) == before  # CPU


def test_bwd_rejects_what_it_does_not_take():
    qkv, g = (torch.from_numpy(x) for x in _inputs(2, 16, seed=4))
    with pytest.raises(ValueError, match="g must be"):
        port.attention_qkv_bwd(qkv, H, None, g[:, :8])
    with pytest.raises(ValueError, match="key_lens"):
        port.attention_qkv_bwd(qkv, H, torch.tensor([0, 16], dtype=torch.int32), g)
