"""The port's CUDA kernels against their plain versions, on the card.

Marked `gpu`; each test skips on a machine without CUDA (the kernels have no
CPU mode). This file imports neither JAX nor the JAX package, so it also
runs where only the port's dependencies are installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_gpu.py

Tolerances: bf16 atol 2e-2 (one bf16 rounding of outputs of magnitude < 1,
plus probability roundings that may fall differently), f32 atol 1e-4. The
backward kernel's bf16 tolerance is 1e-2: a rounding point of p or ds that
falls the other way moves a gradient by a bf16 ulp of it (2^-9 at the
update's shape, for each of dq, dk and dv).
"""

import numpy as np
import pytest
import torch

from safevla_tpu_torch.ops import flash_attention as fa

FUSION_KEY_LENS = [177, 190, 201, 170, 185, 199, 172, 201]
CASES = [
    # (B, S, H, key_lens, dtype, tol): the ViT and fusion shapes of the
    # serving path, f32 at the fusion shape, and no key_lens at all
    (16, 448, 6, [433] * 16, torch.bfloat16, 2e-2),
    (8, 208, 8, FUSION_KEY_LENS, torch.bfloat16, 2e-2),
    (8, 208, 8, FUSION_KEY_LENS, torch.float32, 1e-4),
    (5, 64, 4, None, torch.bfloat16, 2e-2),
]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA; the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False


@pytest.mark.gpu
@pytest.mark.parametrize("b,s,h,key_lens,dtype,tol", CASES)
def test_attention_kernel_matches_plain_version(cuda, b, s, h, key_lens, dtype, tol):
    rng = np.random.default_rng(s)
    qkv = torch.from_numpy(rng.standard_normal((b, s, 3 * h * 64), dtype=np.float32))
    qkv = qkv.to("cuda", dtype)
    kl = None if key_lens is None else torch.tensor(key_lens, dtype=torch.int32, device="cuda")
    before = fa.attention_qkv.launches
    got = fa.attention_qkv(qkv, h, kl)
    want = fa.attention_qkv_reference(qkv, h, kl)
    torch.cuda.synchronize()
    assert fa.attention_qkv.launches == before + 1
    assert got.dtype == dtype and got.shape == (b, s, h * 64)
    assert (got.float() - want.float()).abs().max().item() <= tol


@pytest.mark.gpu
def test_attention_kernel_refuses_what_it_does_not_take(cuda):
    qkv = torch.zeros((2, 16, 3 * 2 * 32), device="cuda", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head_dim"):
        fa.attention_qkv(qkv, 2)  # head dim 32
    with pytest.raises(ValueError, match="bfloat16 or float32"):
        fa.attention_qkv(torch.zeros((2, 16, 384), device="cuda", dtype=torch.float16), 2)
    with pytest.raises(ValueError, match="contiguous"):
        fa.attention_qkv(torch.zeros((2, 384, 16), device="cuda").transpose(1, 2), 2)


UPDATE_KEY_LENS = [169 + n for n in (7, 12, 5, 9)] * 32  # 128 fusion rows of the update
BWD_CASES = [
    # (B, S, H, key_lens, dtype, tol): the update's fusion chunk in bf16 and
    # f32, and no key_lens at all
    (128, 208, 8, UPDATE_KEY_LENS, torch.bfloat16, 1e-2),
    (128, 208, 8, UPDATE_KEY_LENS, torch.float32, 1e-4),
    (5, 64, 4, None, torch.bfloat16, 1e-2),
]


@pytest.mark.gpu
@pytest.mark.parametrize("b,s,h,key_lens,dtype,tol", BWD_CASES)
def test_attention_bwd_kernel_matches_plain_version(cuda, b, s, h, key_lens, dtype, tol):
    rng = np.random.default_rng(s + b)
    qkv = torch.from_numpy(rng.standard_normal((b, s, 3 * h * 64), dtype=np.float32))
    g = torch.from_numpy(rng.standard_normal((b, s, h * 64), dtype=np.float32))
    qkv, g = qkv.to("cuda", dtype), g.to("cuda", dtype)
    kl = None if key_lens is None else torch.tensor(key_lens, dtype=torch.int32, device="cuda")
    before = fa.attention_qkv_bwd.launches
    got = fa.attention_qkv_bwd(qkv, h, kl, g)
    again = fa.attention_qkv_bwd(qkv, h, kl, g)
    want = fa.attention_qkv_bwd_reference(qkv, h, kl, g)
    torch.cuda.synchronize()
    assert fa.attention_qkv_bwd.launches == before + 2
    assert got.dtype == dtype and got.shape == qkv.shape
    assert torch.equal(got, again)  # no atomics: the same bits every run
    assert (got.float() - want.float()).abs().max().item() <= tol
    if key_lens is not None:  # masked keys: dk and dv exactly 0
        lanes = h * 64
        assert torch.all(got[0, key_lens[0] :, lanes:] == 0)


@pytest.mark.gpu
def test_attention_autograd_on_the_card_launches_both_kernels(cuda):
    rng = np.random.default_rng(1)
    qkv = torch.from_numpy(rng.standard_normal((4, 48, 3 * 2 * 64), dtype=np.float32)).cuda()
    kl = torch.tensor([48, 30, 17, 1], dtype=torch.int32, device="cuda")
    qkv.requires_grad_(True)
    before = (fa.attention_qkv.launches, fa.attention_qkv_bwd.launches)
    fa.attention_qkv(qkv, 2, kl).square().sum().backward()
    torch.cuda.synchronize()
    assert (fa.attention_qkv.launches, fa.attention_qkv_bwd.launches) == (before[0] + 1, before[1] + 1)
    want = fa.attention_qkv_bwd_reference(
        qkv.detach(), 2, kl, 2 * fa.attention_qkv_reference(qkv.detach(), 2, kl)
    )
    assert (qkv.grad - want).abs().max().item() <= 1e-4
