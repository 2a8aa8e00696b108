"""Port attention vs the JAX Pallas kernel (interpret mode) on the CPU.

The port's plain `attention_qkv_reference` is the CPU stand-in of the CUDA
kernel; it must match `flash_attention_qkv(..., interpret=True)` — the TPU
kernel's own body — at the path's shapes. Tolerances: 2e-5 in f32 (as
tests/test_flash_attention.py), 3e-2 in bf16 (one bf16 rounding of outputs
of magnitude < 1, plus probability roundings that may fall differently).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from safevla_tpu.ops.flash_attention import flash_attention_qkv
from safevla_tpu_torch.ops import flash_attention as port

CASES = [
    # (B, S, H, key_lens) — fusion layers 0-1 with ragged text, the ViT's
    # 433 valid of 448 tokens, and an unmasked odd batch
    (3, 208, 8, [170, 190, 201]),
    (2, 448, 6, [433, 433]),
    (5, 64, 4, None),
    # the edges of the card kernels' tiles, where the plain version they are
    # held to must be right: one valid key and all S, S = 65 (a tile of 64
    # and one row), a key count on a tile border, one batch row
    (2, 65, 2, [1, 65]),
    (3, 201, 6, [1, 64, 201]),
    (1, 208, 8, [208]),
]


def _inputs(b, s, h, seed):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((b, s, 3 * h * 64), dtype=np.float32)


@pytest.mark.parametrize("b,s,h,key_lens", CASES)
def test_reference_matches_pallas_interpret_f32(b, s, h, key_lens):
    qkv = _inputs(b, s, h, seed=b * 1000 + s)
    kl = None if key_lens is None else np.asarray(key_lens, np.int32)
    want = flash_attention_qkv(
        jnp.asarray(qkv), h, interpret=True, key_lens=None if kl is None else jnp.asarray(kl)
    )
    got = port.attention_qkv(
        torch.from_numpy(qkv), h, None if kl is None else torch.from_numpy(kl)
    )
    assert got.shape == (b, s, h * 64) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)


def test_reference_matches_pallas_interpret_bf16():
    b, s, h = 2, 208, 8
    qkv = _inputs(b, s, h, seed=7)
    kl = np.asarray([169, 201], np.int32)
    want = flash_attention_qkv(
        jnp.asarray(qkv, jnp.bfloat16), h, interpret=True, key_lens=jnp.asarray(kl)
    )
    got = port.attention_qkv(torch.from_numpy(qkv).to(torch.bfloat16), h, torch.from_numpy(kl))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(
        got.float().numpy(), np.asarray(want, np.float32), atol=3e-2
    )


def test_cpu_wrapper_takes_plain_path_without_counting():
    qkv = torch.from_numpy(_inputs(2, 32, 2, seed=3))
    kl = torch.tensor([32, 9], dtype=torch.int32)
    before = port.attention_qkv.launches
    got = port.attention_qkv(qkv, 2, kl)
    assert port.attention_qkv.launches == before
    torch.testing.assert_close(got, port.attention_qkv_reference(qkv, 2, kl), rtol=0, atol=0)


def test_cpu_wrapper_rejects_key_lens_out_of_range():
    qkv = torch.from_numpy(_inputs(2, 32, 2, seed=4))
    for bad in ([0, 32], [32, 33]):
        with pytest.raises(ValueError):
            port.attention_qkv(qkv, 2, torch.tensor(bad, dtype=torch.int32))


def test_dense_attention_matches_packed_reference_f32():
    """The fusion's last-layer path (separate q/k/v, boolean key mask) and the
    packed path agree in f32 on the rows both compute."""
    b, s, h = 3, 48, 2
    qkv = torch.from_numpy(_inputs(b, s, h, seed=5))
    kl = torch.tensor([48, 30, 1], dtype=torch.int32)
    q, k, v = qkv.reshape(b, s, 3, h, 64).unbind(2)
    mask = torch.arange(s)[None, :] < kl[:, None]
    got = port.dense_attention(q, k, v, mask).reshape(b, s, h * 64)
    want = port.attention_qkv_reference(qkv, h, kl)
    torch.testing.assert_close(got, want, rtol=0, atol=2e-5)
