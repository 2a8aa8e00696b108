"""The port's CUDA kernels against their plain versions, on the card.

Marked `gpu`; each test skips on a machine without CUDA (the kernels have no
CPU mode). This file imports neither JAX nor the JAX package, so it also
runs where only the port's dependencies are installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_gpu.py

Tolerances: bf16 atol 2e-2 (one bf16 rounding of outputs of magnitude < 1,
plus probability roundings that may fall differently), f32 atol 1e-4. The
backward kernel's bf16 tolerance is 1e-2: a rounding point of p or ds that
falls the other way moves a gradient by a bf16 ulp of it (2^-9 at the
update's shape, for each of dq, dk and dv); and each of dq, dk and dv lies
within 1e-2 of its own largest |want| (the kernels' worst is ~3e-3 of it),
so a part 2% wrong everywhere fails. The LayerNorm kernels' bf16
outputs reach ~6, so they are held to one bf16 ulp of the plain version
(2^-7 |want| + 1e-3), f32 to 1e-5.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from safevla_tpu_torch.ops import flash_attention as fa

FUSION_KEY_LENS = [177, 190, 201, 170, 185, 199, 172, 201]
SIGLIP_FUSION_KEY_LENS = [169 + n for n in (7, 12, 64, 5, 30, 64, 2, 9)]
CASES = [
    # (B, S, H, key_lens, dtype, tol): the ViT and fusion shapes of the
    # serving path, f32 at the fusion shape, and no key_lens at all
    (16, 448, 6, [433] * 16, torch.bfloat16, 2e-2),
    (8, 208, 8, FUSION_KEY_LENS, torch.bfloat16, 2e-2),
    (8, 208, 8, FUSION_KEY_LENS, torch.float32, 1e-4),
    (5, 64, 4, None, torch.bfloat16, 2e-2),
    # preset=siglip_base: the SigLIP ViT-B/16-256 (256 tokens, no pad: no
    # key_lens) on both cameras of 8 streams, and the fusion at S=240 (1 +
    # 2 * 84 + 64 text tokens = 233, padded to 16)
    (16, 256, 12, None, torch.bfloat16, 2e-2),
    (8, 240, 8, SIGLIP_FUSION_KEY_LENS, torch.bfloat16, 2e-2),
    (8, 240, 8, SIGLIP_FUSION_KEY_LENS, torch.float32, 1e-4),
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


# the edges of the bf16 kernels' tiles (64 query rows and 64 keys a tile in
# the forward, 16-row slices in the backward): S not a multiple of 64, valid
# key counts of 1, of S and on a tile border, one batch row, 6 and 8 heads
EDGE_CASES = [
    # (B, S, H, key_lens)
    (2, 208, 8, [1, 208]),
    (3, 201, 6, [64, 128, 201]),
    (1, 65, 8, [65]),
    (2, 65, 6, [1, 64]),
    (4, 208, 8, [64, 128, 1, 208]),
]
EDGE_DTYPES = [(torch.bfloat16, 2e-2, 1e-2), (torch.float32, 1e-4, 1e-4)]  # (dtype, fwd tol, bwd tol)
BWD_TOL_REL = 1e-2  # each of dq, dk and dv against its own largest |want|


def _assert_bwd_close(got, want, lanes, atol):
    """dqkv within atol of the plain version, and each of dq, dk and dv
    within BWD_TOL_REL of its own largest |want|."""
    diff = (got.float() - want.float()).abs()
    assert diff.max().item() <= atol
    for i, part in enumerate(("dq", "dk", "dv")):
        err = diff[..., i * lanes : (i + 1) * lanes].max().item()
        top = want[..., i * lanes : (i + 1) * lanes].float().abs().max().item()
        assert err <= BWD_TOL_REL * top, (part, err, top)


@pytest.mark.gpu
@pytest.mark.parametrize("b,s,h,key_lens", EDGE_CASES)
@pytest.mark.parametrize("dtype,tol,bwd_tol", EDGE_DTYPES)
def test_attention_kernels_at_tile_edges(cuda, b, s, h, key_lens, dtype, tol, bwd_tol):
    """Forward and backward against their plain versions at the tile edges;
    the backward gives the same bits twice and exactly zero dk and dv on
    every masked key row."""
    rng = np.random.default_rng(b * 1000 + s + h)
    qkv = torch.from_numpy(rng.standard_normal((b, s, 3 * h * 64), dtype=np.float32)).to("cuda", dtype)
    g = torch.from_numpy(rng.standard_normal((b, s, h * 64), dtype=np.float32)).to("cuda", dtype)
    kl = torch.tensor(key_lens, dtype=torch.int32, device="cuda")
    got = fa.attention_qkv(qkv, h, kl)
    want = fa.attention_qkv_reference(qkv, h, kl)
    d = fa.attention_qkv_bwd(qkv, h, kl, g)
    again = fa.attention_qkv_bwd(qkv, h, kl, g)
    d_want = fa.attention_qkv_bwd_reference(qkv, h, kl, g)
    torch.cuda.synchronize()
    assert got.shape == (b, s, h * 64) and torch.isfinite(got).all()
    assert (got.float() - want.float()).abs().max().item() <= tol
    assert torch.equal(d, again)
    lanes = h * 64
    _assert_bwd_close(d, d_want, lanes, bwd_tol)
    for i, n in enumerate(key_lens):
        assert torch.all(d[i, n:, lanes:] == 0)


@pytest.mark.gpu
def test_attention_kernel_refuses_what_it_does_not_take(cuda):
    """Inside JAX's kernel domain (lanes a multiple of 128) the kernels take
    head dim 48 and S 2049 (the streaming design) and head dim 384 (the
    sliced design, lanes 384 and one head): each agrees with the plain
    version; outside it (lanes 64) the plain dense path runs instead."""
    rng = np.random.default_rng(48)
    qkv = torch.from_numpy(rng.standard_normal((2, 16, 3 * 8 * 48), dtype=np.float32)).to("cuda", torch.bfloat16)
    before = fa.attention_qkv.launches
    got = fa.attention_qkv(qkv, 8)  # head dim 48
    assert fa.attention_qkv.launches == before + 1
    assert (got.float() - fa.attention_qkv_reference(qkv, 8).float()).abs().max().item() <= 2e-2
    long = torch.from_numpy(rng.standard_normal((1, 2049, 3 * 128), dtype=np.float32)).to("cuda", torch.bfloat16)
    got = fa.attention_qkv(long, 2)  # S 2049, head dim 64
    assert (got.float() - fa.attention_qkv_reference(long, 2).float()).abs().max().item() <= 2e-2
    wide = torch.from_numpy(rng.standard_normal((2, 16, 3 * 384), dtype=np.float32)).to("cuda", torch.bfloat16)
    got = fa.attention_qkv(wide, 1)  # head dim 384: the sliced design
    assert (got.float() - fa.attention_qkv_reference(wide, 1).float()).abs().max().item() <= 2e-2
    before = fa.attention_qkv.launches
    assert fa.attention_qkv(torch.zeros((2, 16, 3 * 2 * 32), device="cuda"), 2).shape == (2, 16, 64)
    assert fa.attention_qkv.launches == before  # head dim 32 at 64 lanes: JAX's XLA path
    with pytest.raises(ValueError, match="bfloat16 or float32"):
        fa.attention_qkv(torch.zeros((2, 16, 384), device="cuda", dtype=torch.float16), 2)
    with pytest.raises(ValueError, match="contiguous"):
        fa.attention_qkv(torch.zeros((2, 384, 16), device="cuda").transpose(1, 2), 2)


# every head dim of JAX's domain that the resident designs do not take, up to
# 256: odd ones (2-byte copies in bf16), 12 (8-byte bf16 copies), the
# streaming templates' edges; at lanes 384 where the head dim divides it, else
# 256 or 768 lanes; S 100 (two 64-row query tiles, ragged key tiles)
NEW_HEAD_DIMS = [(1, 384), (3, 384), (8, 384), (12, 384), (24, 384), (48, 384), (96, 384),
                 (192, 384), (256, 256), (40, 640), (80, 640), (160, 640)]


@pytest.mark.gpu
@pytest.mark.parametrize("dh,lanes", NEW_HEAD_DIMS)
@pytest.mark.parametrize("dtype,tol,bwd_tol", EDGE_DTYPES)
def test_attention_kernels_at_head_dims_the_resident_designs_do_not_take(cuda, dh, lanes, dtype, tol,
                                                                         bwd_tol):
    """The streaming designs (padded head dims, narrow copies) against their
    plain versions, forward and backward; the backward twice gives the same
    bits and exactly zero dk and dv on the masked key rows."""
    b, s, h = 2, 100, lanes // dh
    rng = np.random.default_rng(dh * 7 + lanes)
    qkv = torch.from_numpy(rng.standard_normal((b, s, 3 * lanes), dtype=np.float32)).to("cuda", dtype)
    g = torch.from_numpy(rng.standard_normal((b, s, lanes), dtype=np.float32)).to("cuda", dtype)
    key_lens = [s, 37]
    kl = torch.tensor(key_lens, dtype=torch.int32, device="cuda")
    assert fa.attention_design("fwd", dtype, dh, s) == fa.attention_design("bwd", dtype, dh, s) == "streaming"
    got = fa.attention_qkv(qkv, h, kl)
    d = fa.attention_qkv_bwd(qkv, h, kl, g)
    again = fa.attention_qkv_bwd(qkv, h, kl, g)
    torch.cuda.synchronize()
    assert (got.float() - fa.attention_qkv_reference(qkv, h, kl).float()).abs().max().item() <= tol
    want = fa.attention_qkv_bwd_reference(qkv, h, kl, g)
    _assert_bwd_close(d, want, lanes, bwd_tol)
    assert torch.equal(d, again)
    assert torch.all(d[1, key_lens[1] :, lanes:] == 0)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol,bwd_tol", EDGE_DTYPES)
def test_attention_kernels_at_s_4096(cuda, dtype, tol, bwd_tol):
    """Past the old limit of 2048: S 4096 at head dim 64 (the streaming
    designs), forward and backward against their plain versions."""
    b, s, h = 1, 4096, 2
    rng = np.random.default_rng(4096)
    qkv = torch.from_numpy(rng.standard_normal((b, s, 3 * h * 64), dtype=np.float32)).to("cuda", dtype)
    g = torch.from_numpy(rng.standard_normal((b, s, h * 64), dtype=np.float32)).to("cuda", dtype)
    kl = torch.tensor([3000], dtype=torch.int32, device="cuda")
    got = fa.attention_qkv(qkv, h, kl)
    d = fa.attention_qkv_bwd(qkv, h, kl, g)
    torch.cuda.synchronize()
    assert (got.float() - fa.attention_qkv_reference(qkv, h, kl).float()).abs().max().item() <= tol
    _assert_bwd_close(d, fa.attention_qkv_bwd_reference(qkv, h, kl, g), h * 64, bwd_tol)
    assert torch.all(d[0, 3000:, h * 64 :] == 0)


# head dims above 256 (the sliced design: 256-wide head slices, the last one
# padded), at lanes 640, 384 and 1024; S 100 (two query tiles, ragged key tiles)
SLICED_HEAD_DIMS = [(320, 640), (384, 384), (512, 1024), (1024, 1024)]


@pytest.mark.gpu
@pytest.mark.parametrize("dh,lanes", SLICED_HEAD_DIMS)
@pytest.mark.parametrize("dtype,tol,bwd_tol", EDGE_DTYPES)
def test_attention_kernels_above_head_dim_256(cuda, dh, lanes, dtype, tol, bwd_tol):
    """The sliced design against its plain versions, forward and backward;
    the backward twice gives the same bits and exactly zero dk and dv on the
    masked key rows."""
    b, s, h = 2, 100, lanes // dh
    rng = np.random.default_rng(dh + lanes)
    qkv = torch.from_numpy(rng.standard_normal((b, s, 3 * lanes), dtype=np.float32)).to("cuda", dtype)
    g = torch.from_numpy(rng.standard_normal((b, s, lanes), dtype=np.float32)).to("cuda", dtype)
    key_lens = [s, 37]
    kl = torch.tensor(key_lens, dtype=torch.int32, device="cuda")
    assert fa.attention_design("fwd", dtype, dh, s) == fa.attention_design("bwd", dtype, dh, s) == "streaming_sliced"
    got = fa.attention_qkv(qkv, h, kl)
    d = fa.attention_qkv_bwd(qkv, h, kl, g)
    again = fa.attention_qkv_bwd(qkv, h, kl, g)
    torch.cuda.synchronize()
    assert (got.float() - fa.attention_qkv_reference(qkv, h, kl).float()).abs().max().item() <= tol
    want = fa.attention_qkv_bwd_reference(qkv, h, kl, g)
    _assert_bwd_close(d, want, lanes, bwd_tol)
    assert torch.equal(d, again)
    assert torch.all(d[1, key_lens[1] :, lanes:] == 0)


@pytest.mark.gpu
@pytest.mark.parametrize("b,h,dh", [(65537, 2, 64), (3, 65536, 2)])
def test_attention_launches_split_past_65535_rows_or_heads(cuda, b, h, dh):
    """A call over more than 65535 batch rows or heads runs as several
    launches (`launch_slices`), counted as one call: f32 forward and
    backward against the plain versions at 1e-4, the rows and heads of the
    last slice included."""
    s, lanes = 8, h * dh
    rng = np.random.default_rng(b + h)
    qkv = torch.from_numpy(rng.standard_normal((b, s, 3 * lanes), dtype=np.float32)).to("cuda")
    g = torch.from_numpy(rng.standard_normal((b, s, lanes), dtype=np.float32)).to("cuda")
    kl = torch.from_numpy(rng.integers(1, s + 1, b).astype(np.int32)).to("cuda")
    assert len(fa.launch_slices(b, h)) == 2
    before = (fa.attention_qkv.launches, fa.attention_qkv_bwd.launches)
    got = fa.attention_qkv(qkv, h, kl)
    d = fa.attention_qkv_bwd(qkv, h, kl, g)
    torch.cuda.synchronize()
    assert (fa.attention_qkv.launches, fa.attention_qkv_bwd.launches) == (before[0] + 1, before[1] + 1)
    assert (got - fa.attention_qkv_reference(qkv, h, kl)).abs().max().item() <= 1e-4
    assert (d - fa.attention_qkv_bwd_reference(qkv, h, kl, g)).abs().max().item() <= 1e-4


# the resident head dims and the long sequences: at 128 lanes every head dim
# of the set (8, 4, 2 and 1 heads), S across the resident designs' limits
# (the bf16 backward's is 432 at head dim 64, 224 at 128) up to 2048, where
# every design streams; key counts of all S and of two thirds of it
LONG_S = [433, 512, 1024, 2048]


@pytest.mark.gpu
@pytest.mark.parametrize("dh", [16, 32, 64, 128])
@pytest.mark.parametrize("s", LONG_S)
@pytest.mark.parametrize("dtype,tol,bwd_tol", EDGE_DTYPES)
def test_attention_kernels_at_every_head_dim_and_long_s(cuda, dh, s, dtype, tol, bwd_tol):
    """Forward and backward (resident or streaming, as the shape rule picks)
    against their plain versions; the backward twice gives the same bits and
    exactly zero dk and dv on the masked key rows."""
    b, h = 2, 128 // dh
    lanes = h * dh
    rng = np.random.default_rng(dh * 10000 + s)
    qkv = torch.from_numpy(rng.standard_normal((b, s, 3 * lanes), dtype=np.float32)).to("cuda", dtype)
    g = torch.from_numpy(rng.standard_normal((b, s, lanes), dtype=np.float32)).to("cuda", dtype)
    key_lens = [s, 2 * s // 3]
    kl = torch.tensor(key_lens, dtype=torch.int32, device="cuda")
    before = (fa.attention_qkv.launches, fa.attention_qkv_bwd.launches)
    got = fa.attention_qkv(qkv, h, kl)
    d = fa.attention_qkv_bwd(qkv, h, kl, g)
    again = fa.attention_qkv_bwd(qkv, h, kl, g)
    torch.cuda.synchronize()
    assert (fa.attention_qkv.launches, fa.attention_qkv_bwd.launches) == (before[0] + 1, before[1] + 2)
    assert (got.float() - fa.attention_qkv_reference(qkv, h, kl).float()).abs().max().item() <= tol
    want = fa.attention_qkv_bwd_reference(qkv, h, kl, g)
    _assert_bwd_close(d, want, lanes, bwd_tol)
    assert torch.equal(d, again)
    assert torch.all(d[1, key_lens[1] :, lanes:] == 0)


UPDATE_KEY_LENS = [169 + n for n in (7, 12, 5, 9)] * 32  # 128 fusion rows of the update
BWD_CASES = [
    # (B, S, H, key_lens, dtype, tol): the update's fusion chunk in bf16 and
    # f32, and no key_lens at all
    (128, 208, 8, UPDATE_KEY_LENS, torch.bfloat16, 1e-2),
    (128, 208, 8, UPDATE_KEY_LENS, torch.float32, 1e-4),
    (5, 64, 4, None, torch.bfloat16, 1e-2),
    # the siglip_base update's fusion chunk at S=240
    (128, 240, 8, SIGLIP_FUSION_KEY_LENS * 16, torch.bfloat16, 1e-2),
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
    lanes = h * 64
    _assert_bwd_close(got, want, lanes, tol)
    if key_lens is not None:  # masked keys: dk and dv exactly 0
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


# The resident bf16 designs (wgmma, TMA and mbarriers): key counts on and
# beside their 16- and 64-row tiles and all S keys, S across the tiles and
# the forward's one-pass line (256), at every head dim (lanes 128)
WG_KEY_COUNTS = [1, 15, 16, 17, 63, 64, 65]
WG_LENGTHS = [(dh, s) for dh in (16, 32, 64, 128) for s in (16, 64, 65, 208, 240, 256)]


def _wg_inputs(dh, s, key_lens, seed):
    h = 128 // dh
    rng = np.random.default_rng(seed)
    qkv = torch.from_numpy(rng.standard_normal((len(key_lens), s, 3 * 128), dtype=np.float32))
    g = torch.from_numpy(rng.standard_normal((len(key_lens), s, 128), dtype=np.float32))
    kl = torch.tensor(key_lens, dtype=torch.int32, device="cuda")
    return h, qkv.to("cuda", torch.bfloat16), g.to("cuda", torch.bfloat16), kl


def _check_fwd(qkv, h, kl):
    before = fa.attention_qkv.launches
    got = fa.attention_qkv(qkv, h, kl)
    want = fa.attention_qkv_reference(qkv, h, kl)
    torch.cuda.synchronize()
    assert fa.attention_qkv.launches == before + 1
    assert got.shape == want.shape and torch.isfinite(got).all()
    assert (got.float() - want.float()).abs().max().item() <= 2e-2


def _check_bwd(qkv, h, kl, g, key_lens):
    """Within 1e-2 of the plain version and each part within BWD_TOL_REL
    of its largest |want|, the same bits twice, exactly zero dk and dv on
    every masked key row."""
    before = fa.attention_qkv_bwd.launches
    got = fa.attention_qkv_bwd(qkv, h, kl, g)
    again = fa.attention_qkv_bwd(qkv, h, kl, g)
    want = fa.attention_qkv_bwd_reference(qkv, h, kl, g)
    torch.cuda.synchronize()
    assert fa.attention_qkv_bwd.launches == before + 2
    assert got.shape == want.shape and torch.isfinite(got).all()
    assert torch.equal(got, again)
    _assert_bwd_close(got, want, 128, 1e-2)
    for i, n in enumerate(key_lens):
        assert torch.all(got[i, n:, 128:] == 0), (i, n)


@pytest.mark.gpu
@pytest.mark.parametrize("dh,s", WG_LENGTHS)
def test_resident_attention_designs_at_key_counts_and_lengths(cuda, dh, s):
    key_lens = sorted({min(k, s) for k in WG_KEY_COUNTS} | {s})
    h, qkv, g, kl = _wg_inputs(dh, s, key_lens, seed=dh * 1000 + s)
    for kind in ("fwd", "bwd"):  # the backward's limit at head dim 128 is 224: 240 and 256 stream
        resident = s <= fa.resident_max_s(kind, torch.bfloat16, dh)
        assert fa.attention_design(kind, torch.bfloat16, dh, s) == ("resident" if resident else "streaming")
    _check_fwd(qkv, h, kl)
    _check_bwd(qkv, h, kl, g, key_lens)


@pytest.mark.gpu
@pytest.mark.parametrize("dh", [16, 32, 64, 128])
@pytest.mark.parametrize("kind", ["fwd", "bwd"])
def test_resident_attention_designs_at_their_largest_s_and_past_it(cuda, dh, kind):
    """S = resident_max_s (the resident design) and 16 past it (the
    streaming design), all keys and two thirds of them."""
    top = fa.resident_max_s(kind, torch.bfloat16, dh)
    for s, design in ((top, "resident"), (top + 16, "streaming")):
        assert fa.attention_design(kind, torch.bfloat16, dh, s) == design
        key_lens = [s, 2 * s // 3]
        h, qkv, g, kl = _wg_inputs(dh, s, key_lens, seed=s)
        if kind == "fwd":
            _check_fwd(qkv, h, kl)
        else:
            _check_bwd(qkv, h, kl, g, key_lens)


@pytest.mark.gpu
def test_resident_attention_entries_refuse_past_their_largest_s(cuda):
    """The C entries of the resident designs return cudaErrorInvalidValue
    (1) 16 rows past `resident_max_s`, at every head dim: the wrapper's
    limit and the kernels' shared-memory layouts draw one line."""
    import math

    from safevla_tpu_torch.ops import _build

    fwd = _build.load_library("flash_attention_fwd", fa._C_ARGTYPES)
    bwd = _build.load_library("flash_attention_bwd", fa._C_ARGTYPES_BWD)
    stream = torch.cuda.current_stream().cuda_stream
    for dh in fa.KERNEL_HEAD_DIMS:
        h = 128 // dh
        for kind, lib in (("fwd", fwd), ("bwd", bwd)):
            s = fa.resident_max_s(kind, torch.bfloat16, dh) + 16
            qkv = torch.zeros((1, s, 3 * 128), dtype=torch.bfloat16, device="cuda")
            out = torch.empty_like(qkv)
            common = (1, s, h, 0, h, dh, qkv.stride(0), qkv.stride(1), 1.0 / math.sqrt(dh), 0, stream)
            with pytest.raises(RuntimeError, match=r"\(cudaError 1\)"):
                if kind == "fwd":
                    _build.launch(lib, "attention_qkv_fwd", qkv.data_ptr(), None, out.data_ptr(), *common)
                else:
                    g = torch.zeros((1, s, 128), dtype=torch.bfloat16, device="cuda")
                    _build.launch(lib, "attention_qkv_bwd", qkv.data_ptr(), g.data_ptr(), None, out.data_ptr(),
                                  *common)


@pytest.mark.gpu
@pytest.mark.parametrize("lib", ["flash_attention_fwd", "flash_attention_bwd"])
def test_resident_attention_kernels_run_wgmma_and_tma_without_spills(cuda, lib):
    """Each resident bf16 kernel's SASS holds warpgroup products (HGMMA) and
    TMA tile loads (UTMALDG) at every head dim, and ptxas's report gives it
    no spill."""
    import pathlib
    import re
    import subprocess

    from safevla_tpu_torch.ops import _build

    _build.build([lib])
    cuobjdump = pathlib.Path(_build.nvcc_path()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", str(_build.library_path(lib))],
                          capture_output=True, text=True, check=True, timeout=300).stdout
    found = {}
    for part in sass.split("Function : ")[1:]:
        m = re.search(r"attention_(?:fwd|bwd)_wg_kernelILi(\d+)E", part.split("\n", 1)[0])
        if m:  # the forward has a kernel for each of its consumer counts
            found.setdefault(int(m.group(1)), set()).add(("HGMMA" in part, "UTMALDG" in part))
    assert found == {dh: {(True, True)} for dh in fa.KERNEL_HEAD_DIMS}, found
    log = _build.build_log(lib)
    for part in log.split("Compiling entry function '")[1:]:
        if "wg_kernel" in part.split("'", 1)[0]:
            assert re.search(r"\b0 bytes spill stores, 0 bytes spill loads", part), part[:400]


# (R, D, x dtype, out dtype): every LayerNorm shape of the trainer's path
# (ViT rows of 2G = 32 frames x 448 tokens at D 384, bf16 out and the final
# norm's f32 out; fusion rows of G = 16 samples x 208 tokens and the CLS
# rows; the update's 128-sample chunk) and f32 configs
LN_CASES = [
    (32 * 448, 384, torch.bfloat16, torch.bfloat16),
    (32 * 448, 384, torch.bfloat16, torch.float32),
    (16 * 208, 512, torch.bfloat16, torch.bfloat16),
    (16, 512, torch.bfloat16, torch.bfloat16),
    (128 * 208, 512, torch.bfloat16, torch.bfloat16),
    (128, 512, torch.bfloat16, torch.bfloat16),
    (40, 512, torch.float32, torch.float32),
    (13, 1024, torch.float32, torch.bfloat16),
    # preset=siglip_base: the ViT-B rows of 16 frames x 256 tokens at D 768
    # (bf16 out, the final norm's f32 out) and the fusion's 8 x 240 rows
    (16 * 256, 768, torch.bfloat16, torch.bfloat16),
    (16 * 256, 768, torch.bfloat16, torch.float32),
    (8 * 240, 512, torch.bfloat16, torch.bfloat16),
]
# the edges of the tiling: one row, a ragged block (8 rows a block in the
# one-pass forward, a row a warp; 16 bf16 rows in its loop, a row a
# half-warp), 132 * k rows or blocks +- 1 (k = 1 and 2: a wave of one or two
# blocks an SM; 16: the backward's largest grid of 264 blocks), and
# 1056 * k +- 1 for k = 3, 4, 5, 6 and 8 (the move from one pass to the loop
# at k blocks of 8 rows an SM) and 16 (two such waves), at the path's D and
# at the narrowest and widest D the kernels take
LN_EDGE_ROWS = [1, 17, 131, 133, 263, 265, 2111, 2113, 3167, 3169, 4223, 4225, 5279, 5281, 6335, 6337,
                8447, 8449, 16895, 16897]
LN_CASES += [
    (r, d, dtype, dtype)
    for dtype in (torch.bfloat16, torch.float32)
    for d, rows in ((384, LN_EDGE_ROWS), (512, LN_EDGE_ROWS), (128, [17, 133, 2113]), (1024, [17, 133, 2113]))
    for r in rows
]
# the wide designs (D above 1024): one row, a ragged share of the grid, more
# rows than one wave, and a bf16 row to an f32 output
LN_CASES += [
    (r, d, dtype, dtype)
    for dtype in (torch.bfloat16, torch.float32)
    for d in (1152, 2048, 4096)
    for r in (1, 133, 2113)
] + [(257, 2048, torch.bfloat16, torch.float32)]


def _ln_inputs(r, d, dtype, seed):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy((3 * rng.standard_normal((r, d)) + 1).astype(np.float32)).to("cuda", dtype)
    gamma = torch.from_numpy((1 + 0.2 * rng.standard_normal(d)).astype(np.float32)).cuda()
    beta = torch.from_numpy((0.2 * rng.standard_normal(d)).astype(np.float32)).cuda()
    return x, gamma, beta


def _ln_close(got, want):
    """bf16: within one bf16 ulp of the reference, 2^-7 |want| (+ 1e-3 near
    0), since one rounding may fall the other way; f32 within 1e-5."""
    diff = (got.float() - want.float()).abs()
    if got.dtype == torch.bfloat16:
        return bool((diff <= 2**-7 * want.float().abs() + 1e-3).all())
    return diff.max().item() <= 1e-5


@pytest.mark.gpu
@pytest.mark.parametrize("r,d,dtype,out_dtype", LN_CASES)
def test_layer_norm_kernels_match_plain_versions(cuda, r, d, dtype, out_dtype):
    """Forward and dx: bf16 within one bf16 ulp of the plain version, f32
    within 1e-5; dgamma / dbeta within 1e-4 of their magnitude; two backward
    runs give the same bits (partial rows, no atomics)."""
    from safevla_tpu_torch.ops import layer_norm as ln

    x, gamma, beta = _ln_inputs(r, d, dtype, r + d)
    before = (ln.layer_norm.launches, ln.layer_norm_bwd.launches)
    got = ln.layer_norm(x, gamma, beta, 1e-6, out_dtype)
    want = ln.layer_norm_fwd_reference(x, gamma, beta, 1e-6, out_dtype)
    assert got.dtype == out_dtype and got.shape == (r, d)
    assert _ln_close(got, want)

    g = torch.randn((r, d), generator=torch.Generator("cuda").manual_seed(r), device="cuda").to(out_dtype)
    dx, dgamma, dbeta = ln.layer_norm_bwd(x, gamma, g)
    again = ln.layer_norm_bwd(x, gamma, g)
    wdx, wdgamma, wdbeta = ln.layer_norm_bwd_reference(x, gamma, g)
    torch.cuda.synchronize()
    assert (ln.layer_norm.launches, ln.layer_norm_bwd.launches) == (before[0] + 1, before[1] + 2)
    assert all(torch.equal(a, b) for a, b in zip((dx, dgamma, dbeta), again))
    assert dx.dtype == dtype and dgamma.dtype == dbeta.dtype == torch.float32
    assert _ln_close(dx, wdx)
    for a, b in ((dgamma, wdgamma), (dbeta, wdbeta)):
        assert (a - b).abs().max().item() <= 1e-4 * (1 + b.abs().max().item())


@pytest.mark.gpu
def test_layer_norm_autograd_on_the_card_launches_both_kernels(cuda):
    from safevla_tpu_torch.ops import layer_norm as ln

    x, gamma, beta = _ln_inputs(24, 256, torch.float32, 5)
    x, gamma, beta = (t.requires_grad_(True) for t in (x, gamma, beta))
    before = (ln.layer_norm.launches, ln.layer_norm_bwd.launches)
    ln.layer_norm(x.view(4, 6, 256), gamma, beta).square().sum().backward()
    torch.cuda.synchronize()
    assert (ln.layer_norm.launches, ln.layer_norm_bwd.launches) == (before[0] + 1, before[1] + 1)
    y = ln.layer_norm_fwd_reference(x.detach(), gamma.detach(), beta.detach())
    wdx, wdg, wdb = ln.layer_norm_bwd_reference(x.detach(), gamma.detach(), 2 * y)
    for got, want in ((x.grad, wdx), (gamma.grad, wdg), (beta.grad, wdb)):
        assert (got - want).abs().max().item() <= 1e-4


@pytest.mark.gpu
def test_layer_norm_kernel_refuses_what_it_does_not_take(cuda):
    from safevla_tpu_torch.ops import layer_norm as ln

    gamma, beta = torch.ones(1152, device="cuda"), torch.zeros(1152, device="cuda")
    x = torch.randn((4, 1152), device="cuda")
    before = ln.layer_norm.launches
    got = ln.layer_norm(x, gamma, beta)  # D 1152: the wide design
    assert ln.layer_norm.launches == before + 1 and ln.ln_design(1152) == "wide"
    assert _ln_close(got, ln.layer_norm_fwd_reference(x, gamma, beta))
    with pytest.raises(ValueError, match="multiple of 128"):
        ln.layer_norm_bwd(torch.zeros((4, 192), device="cuda"), gamma[:192], torch.zeros((4, 192), device="cuda"))
    with pytest.raises(ValueError, match="bfloat16 or float32"):
        ln.layer_norm(torch.zeros((4, 128), device="cuda", dtype=torch.float16), gamma[:128], beta[:128])
    # D = 192 is not a multiple of 128: JAX's plain math, no launch
    before = ln.layer_norm.launches
    x = torch.randn((4, 192), device="cuda")
    got = ln.layer_norm(x, gamma[:192], beta[:192])
    assert ln.layer_norm.launches == before
    assert torch.equal(got, ln.layer_norm_fwd_reference(x, gamma[:192], beta[:192]))


@pytest.mark.gpu
def test_compat_layer_norm_routes_to_the_kernel_on_the_card(cuda):
    """On the card CompatLayerNorm launches the kernel at a width that is a
    multiple of 128 (and agrees with its plain code), 1152 included (the wide
    design), runs its plain code without a launch at any other width; the
    adapter norms (PlainLayerNorm) never launch it."""
    from safevla_tpu_torch.models.norms import CompatLayerNorm, PlainLayerNorm
    from safevla_tpu_torch.ops import layer_norm as ln

    x, _, _ = _ln_inputs(16, 384, torch.bfloat16, 3)
    mod = CompatLayerNorm(384, out_dtype=torch.bfloat16).cuda()
    before = ln.layer_norm.launches
    got = mod(x.view(2, 8, 384))
    assert ln.layer_norm.launches == before + 1
    PlainLayerNorm(384).cuda()(x)
    assert ln.layer_norm.launches == before + 1
    assert _ln_close(got.view(16, 384), mod.plain(x))
    narrow = CompatLayerNorm(192).cuda()
    assert torch.equal(narrow(x[:, :192]), narrow.plain(x[:, :192]))
    assert ln.layer_norm.launches == before + 1
    wide = CompatLayerNorm(1152).cuda()
    xw = torch.randn((2, 1152), device="cuda")
    assert _ln_close(wide(xw), wide.plain(xw))
    assert ln.layer_norm.launches == before + 2


def _device_activity_names(fn, calls):
    """Names of the device activities of `calls` calls of fn(), from the
    profiler. A profiled run in which it saw no device activity at all (it
    misses a whole run now and then) is taken again, up to three times."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        names = [e.name() for e in prof.profiler.kineto_results.events() if e.device_type() == DeviceType.CUDA]
        if names:
            break
    return names


@pytest.mark.gpu
@pytest.mark.parametrize("r", [128, 128 * 208])
def test_layer_norm_bwd_runs_only_the_chosen_designs_kernels(cuda, r):
    """One backward call is one cooperative kernel, dgamma and dbeta
    included: no other kernel, copy or set."""
    from safevla_tpu_torch.ops import layer_norm as ln

    x, gamma, _ = _ln_inputs(r, 512, torch.bfloat16, 4)
    g = torch.randn((r, 512), generator=torch.Generator("cuda").manual_seed(4), device="cuda").to(torch.bfloat16)
    names = _device_activity_names(lambda: ln.layer_norm_bwd(x, gamma, g), calls=4)
    assert len(names) == 4, names
    assert all("layer_norm_bwd" in n for n in names), names


@pytest.mark.gpu
def test_layer_norm_bwd_on_two_streams_at_once_gives_the_same_bits(cuda):
    """Backward calls on two CUDA streams at once (each a grid of the
    card's co-resident size, each with its own workspace) give the bits of
    a call on the default stream."""
    from safevla_tpu_torch.ops import layer_norm as ln

    r = 128 * 208
    x, gamma, _ = _ln_inputs(r, 512, torch.bfloat16, 6)
    g = torch.randn((r, 512), generator=torch.Generator("cuda").manual_seed(6), device="cuda").to(torch.bfloat16)
    want = ln.layer_norm_bwd(x, gamma, g)
    torch.cuda.synchronize()
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    outs = []
    for s in streams:
        with torch.cuda.stream(s):
            outs.append([ln.layer_norm_bwd(x, gamma, g) for _ in range(4)])
    torch.cuda.synchronize()
    for calls in outs:
        for got in calls:
            assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.gpu
def test_tiny_test_config_acts_and_updates_on_the_card(cuda, monkeypatch):
    """The tiny config of tests/conftest.py (ViT width 32, head dim 16, fusion
    lanes 64, LayerNorm widths 32 and 64) takes JAX's plain paths at every
    site, so it runs on the card (it raised ValueError before the kernels
    dispatched by JAX's rules) and launches no kernel; with f32 encoders its
    acts match the CPU at the serving test's 1e-4 and one update at the
    learner test's tolerances (metrics 1e-4; weights 1e-4, their change 1e-5)."""
    import functools

    from safevla_tpu_torch.algo.learner import Learner
    from safevla_tpu_torch.config import Config, ModelConfig, TrainConfig
    from safevla_tpu_torch.evaluation.agent import InferenceAgent
    from safevla_tpu_torch.models import actor_critic, t5, vit
    from safevla_tpu_torch.ops import layer_norm as ln

    monkeypatch.setitem(vit.VIT_CONFIGS, "gpu_test_tiny", vit.DinoViTConfig(
        embed_dim=32, depth=1, num_heads=2, img_height=28, img_width=42, patch_size=14, dtype=torch.float32))
    monkeypatch.setattr(actor_critic, "T5Config", functools.partial(t5.T5Config, dtype=torch.float32))
    m = ModelConfig(
        hidden_size=64, num_tx_layers=2, num_tx_heads=4, goal_dims=64, text_embed_size=64,
        combiner_layers=1, combiner_heads=4, combiner_ffn_dim=128, dino_compressor_hidden_out_dims=(64, 64),
        vision_backbone="gpu_test_tiny", vision_feature_dim=32, image_size=(28, 42), max_steps=16,
        text_max_tokens=8, compute_dtype="float32",
    )
    cfg = Config(m, TrainConfig(max_steps=16))
    cfg.ppo.update_repeats = 2
    before = (fa.attention_qkv.launches, fa.attention_qkv_bwd.launches, ln.layer_norm.launches,
              ln.layer_norm_bwd.launches)
    agents = {d: InferenceAgent.build(cfg, None, num_streams=2, test_augmentation=False, device=d)
              for d in ("cpu", "cuda")}
    rng = np.random.default_rng(3)
    for a in agents.values():
        a.set_instructions(["find a mug", "go to the bed"])
    for t in range(3):
        nav, manip = rng.integers(0, 256, (2, 2, 28, 42, 3), dtype=np.uint8)
        out = {}
        for d, a in agents.items():
            a.act(nav, manip, np.full(2, int(t > 0)), np.zeros(2, np.int32))
            out[d] = np.concatenate([np.log(a.last_probs).ravel(), *a.last_values])
        np.testing.assert_allclose(out["cuda"], out["cpu"], atol=1e-4)

    b, steps, length = 2, 6, 8
    batch = {
        "dino_nav": rng.standard_normal((b, steps, 7, 12, 32)).astype(np.float32),
        "dino_manip": rng.standard_normal((b, steps, 7, 12, 32)).astype(np.float32),
        "text_hidden": rng.standard_normal((b, length, 64)).astype(np.float32),
        "text_mask": np.arange(length)[None, :] < np.array([[3], [8]]),
        "prev_actions": rng.integers(0, m.num_actions, (b, steps)).astype(np.int32),
        "not_reset": np.concatenate([np.zeros((b, 1)), np.ones((b, steps - 1))], 1).astype(np.int32),
        "object_in_hand": np.zeros((b, steps), np.int32),
        "time_step": np.tile(np.arange(steps, dtype=np.int32), (b, 1)),
        "traj_idx": np.zeros((b, steps), np.int32),
        "actions": rng.integers(0, m.num_actions, (b, steps)).astype(np.int32),
        "old_log_probs": np.full((b, steps), -3.0, np.float32),
        "rewards": rng.standard_normal((b, steps)).astype(np.float32),
        "costs": rng.integers(0, 3, (b, steps)).astype(np.float32),
        "values": rng.standard_normal((b, steps + 1)).astype(np.float32),
        "c_values": rng.standard_normal((b, steps + 1)).astype(np.float32),
        "masks": np.ones((b, steps + 1), np.float32),
    }
    result = {}
    for d, a in agents.items():
        learner = Learner(a.policy, cfg)
        ts = learner.init()
        start = [p.detach().cpu().clone() for p in ts.tower_params.values()]
        ts, metrics = learner.update(ts, {k: torch.as_tensor(v, device=d) for k, v in batch.items()}, 3.0, 1)
        result[d] = ({k: float(v) for k, v in metrics.items()},
                     [p.detach().cpu() for p in ts.tower_params.values()], start)
    torch.cuda.synchronize()
    (m_cpu, w_cpu, s_cpu), (m_gpu, w_gpu, _) = result["cpu"], result["cuda"]
    for k in m_cpu:
        np.testing.assert_allclose(m_gpu[k], m_cpu[k], atol=1e-4, err_msg=k)
    for g, w, s in zip(w_gpu, w_cpu, s_cpu):
        assert (g - w).abs().max().item() <= 1e-4 and ((g - s) - (w - s)).abs().max().item() <= 1e-5
    after = (fa.attention_qkv.launches, fa.attention_qkv_bwd.launches, ln.layer_norm.launches,
             ln.layer_norm_bwd.launches)
    assert after == before  # every site takes the plain path at these widths


def _small_config(critic_type):
    """A small f32 policy whose attention (head dim 64, 128 lanes) and
    LayerNorm (D 128) sites take the kernels on the card."""
    from safevla_tpu_torch.config import Config, ModelConfig, TrainConfig
    from safevla_tpu_torch.models import vit

    vit.VIT_CONFIGS.setdefault("gpu_test_small", vit.DinoViTConfig(
        embed_dim=128, depth=2, num_heads=2, img_height=28, img_width=42, dtype=torch.float32))
    m = ModelConfig(
        hidden_size=128, num_tx_layers=2, num_tx_heads=2, goal_dims=128, text_embed_size=128, combiner_layers=3,
        combiner_heads=2, combiner_ffn_dim=256, dino_compressor_hidden_out_dims=(128, 128),
        vision_backbone="gpu_test_small", vision_feature_dim=128, image_size=(28, 42), max_steps=8,
        text_max_tokens=8, compute_dtype="float32", critic_type=critic_type, fusion_chunk=8,
    )
    return Config(m, TrainConfig(max_steps=8))


@pytest.mark.gpu
def test_discrete_critic_update_on_the_card_matches_the_cpu(cuda):
    """One stage-1 Learner.update of the HL-Gauss discrete critic on the
    card against the CPU, from the same weights and batch: metrics within
    1e-4 (1 + |x|), weights within 1e-5; the kernels ran on the card."""
    from safevla_tpu_torch.algo.learner import Learner
    from safevla_tpu_torch.models.actor_critic import SafeVLAPolicy
    from safevla_tpu_torch.ops import layer_norm as ln

    cfg = _small_config("discrete")
    m = cfg.model
    rng = np.random.default_rng(5)
    b, steps, length = 3, 8, m.text_max_tokens
    not_reset = np.ones((b, steps), np.int32)
    not_reset[:, 0] = 0
    not_reset[1, 4] = 0
    batch = {
        "dino_nav": rng.standard_normal((b, steps, 7, 12, 128)).astype(np.float32),
        "dino_manip": rng.standard_normal((b, steps, 7, 12, 128)).astype(np.float32),
        "text_hidden": rng.standard_normal((b, length, 128)).astype(np.float32),
        "text_mask": np.arange(length)[None, :] < np.array([[3], [8], [5]]),
        "prev_actions": rng.integers(0, m.num_actions, (b, steps)).astype(np.int32),
        "not_reset": not_reset,
        "object_in_hand": rng.integers(0, 3, (b, steps)).astype(np.int32),
        "time_step": np.tile(np.arange(steps, dtype=np.int32), (b, 1)),
        "traj_idx": (np.cumsum(1 - not_reset, axis=1) - 1).astype(np.int32),
        "actions": rng.integers(0, m.num_actions, (b, steps)).astype(np.int32),
        "old_log_probs": np.full((b, steps), -3.0, np.float32),
        "rewards": rng.standard_normal((b, steps)).astype(np.float32),
        "costs": rng.integers(0, 3, (b, steps)).astype(np.float32),
        "values": rng.standard_normal((b, steps + 1)).astype(np.float32),
        "c_values": rng.standard_normal((b, steps + 1)).astype(np.float32),
        "masks": np.concatenate([not_reset, np.ones((b, 1), np.int32)], 1).astype(np.float32),
    }
    before = (fa.attention_qkv_bwd.launches, ln.layer_norm_bwd.launches)
    out = {}
    for d in ("cpu", "cuda"):
        learner = Learner(SafeVLAPolicy(m, device=d, generator=torch.Generator().manual_seed(3)), cfg)
        ts, metrics = learner.update(learner.init(), batch, 3.0, 1)
        out[d] = ({k: float(v) for k, v in metrics.items()},
                  torch.cat([p.detach().cpu().flatten() for p in ts.tower_params.values()]))
    torch.cuda.synchronize()
    (m_cpu, w_cpu), (m_gpu, w_gpu) = out["cpu"], out["cuda"]
    assert m_gpu["value"] > 0 and m_gpu["c_value"] > 0  # HL-Gauss cross-entropies
    for k in m_cpu:
        assert abs(m_gpu[k] - m_cpu[k]) <= 1e-4 * (1 + abs(m_cpu[k])), k
    assert (w_gpu - w_cpu).abs().max().item() <= 1e-5
    assert fa.attention_qkv_bwd.launches > before[0] and ln.layer_norm_bwd.launches > before[1]


@pytest.mark.gpu
def test_train_online_smoke_cli_on_the_card(cuda, tmp_path):
    """`cli.train_online --smoke` on the card (its default device) with
    FetchType and the discrete critic: the async pipeline runs to its total
    steps (96 learned: one window past, 128) and writes its checkpoint."""
    from safevla_tpu_torch.cli import train_online

    ts = train_online.main(["--smoke", "train.task_type=FetchType", "model.critic_type=discrete",
                            f"train.output_dir={tmp_path}"])
    assert ts.step == 128
    assert next(iter(ts.tower_params.values())).is_cuda
    assert os.path.isfile(os.path.join(tmp_path, "SafeVLA-TPU-ObjectNavType", "step_128", "train_state.pt"))


def _secondary_config(backbone):
    """A small f32 policy with a secondary encoder: the SigLIP ViT (patch 14
    on 28x42, no CLS) and text tower, or CLIP's ResNet at width 8 on 64x96."""
    from safevla_tpu_torch.config import ModelConfig

    m = ModelConfig(
        hidden_size=64, num_tx_layers=2, num_tx_heads=4, goal_dims=64, text_embed_size=64,
        combiner_layers=1, combiner_heads=4, combiner_ffn_dim=128, dino_compressor_hidden_out_dims=(64, 64),
        vision_feature_dim=32, image_size=(28, 42), max_steps=16, text_max_tokens=8, compute_dtype="float32",
    )
    if backbone == "siglip":
        return dataclasses.replace(m, vision_backbone="gpu_test_siglip", text_backbone="siglip_base")
    return dataclasses.replace(m, vision_backbone="gpu_test_clip", vision_feature_dim=256, image_size=(64, 96))


def _register_secondary(monkeypatch):
    import functools

    from safevla_tpu_torch.models import actor_critic, resnet, t5, text_towers, vit

    monkeypatch.setitem(vit.VIT_CONFIGS, "gpu_test_siglip", vit.DinoViTConfig(
        embed_dim=32, depth=1, num_heads=2, img_height=28, img_width=42, patch_size=14, layerscale=False,
        use_cls_token=False, dtype=torch.float32))
    monkeypatch.setitem(resnet.RESNET_CONFIGS, "gpu_test_clip", resnet.ClipResNetConfig(
        width=8, layers=(1, 1, 1, 1), dtype=torch.float32))
    monkeypatch.setattr(actor_critic, "T5Config", functools.partial(t5.T5Config, dtype=torch.float32))
    monkeypatch.setattr(actor_critic, "TextTowerConfig", functools.partial(text_towers.TextTowerConfig,
                                                                           dtype=torch.float32))
    # f32 convolutions in f32, not TF32 (cuDNN's default)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)


@pytest.mark.gpu
@pytest.mark.parametrize("backbone", ["siglip", "clip"])
def test_secondary_encoder_policies_act_on_the_card_as_on_the_cpu(cuda, backbone, monkeypatch):
    """A small f32 policy with the SigLIP encoders, or with CLIP's ResNet,
    acts on the card as on the CPU (the serving test's 1e-4), its
    instructions holding ids past the text tower's 32000 rows."""
    from safevla_tpu_torch.config import Config, TrainConfig
    from safevla_tpu_torch.evaluation.agent import InferenceAgent

    _register_secondary(monkeypatch)
    m = _secondary_config(backbone)
    cfg = Config(m, TrainConfig(max_steps=16))
    agents = {d: InferenceAgent.build(cfg, None, num_streams=2, test_augmentation=False, device=d)
              for d in ("cpu", "cuda")}
    rng = np.random.default_rng(4)
    for a in agents.values():
        a.set_instructions(["find the green stove", "go to the bed on the right"])  # ids >= 32000
    h, w = m.image_size
    for t in range(3):
        nav, manip = rng.integers(0, 256, (2, 2, h, w, 3), dtype=np.uint8)
        out = {}
        for d, a in agents.items():
            a.act(nav, manip, np.full(2, int(t > 0)), np.zeros(2, np.int32))
            out[d] = np.concatenate([np.log(a.last_probs).ravel(), *a.last_values])
        np.testing.assert_allclose(out["cuda"], out["cpu"], atol=1e-4)


@pytest.mark.gpu
def test_text_tower_clamps_ids_past_its_vocabulary_on_the_card(cuda):
    """Ids at and past the vocabulary read its last row on the card too (an
    nn.Embedding lookup would trip a device-side assert)."""
    from safevla_tpu_torch.models.text_towers import SigLIPTextEncoder, TextTowerConfig

    enc = SigLIPTextEncoder(TextTowerConfig(vocab_size=100, d_model=64, num_layers=2, num_heads=4, max_tokens=8,
                                            dtype=torch.float32))
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():  # every weight set (the module leaves in_proj_weight to its owner's init)
        for p in enc.parameters():
            p.copy_(0.1 * torch.randn(p.shape, generator=gen))
    tokens = torch.tensor([[3, 99, 100, 32127, 1, 0, 0, 0], [5, 150, 7, 1, 0, 0, 0, 0]])
    mask = tokens != 0
    with torch.no_grad():
        want = enc(tokens.clamp(max=99), mask)
        got = enc.cuda()(tokens.cuda(), mask.cuda())
    torch.cuda.synchronize()
    assert torch.isfinite(want).all()
    torch.testing.assert_close(got.cpu(), want, atol=1e-4, rtol=0)  # f32, card against CPU (this file's 1e-4)


@pytest.mark.gpu
def test_frozen_batch_norm_rounds_once_on_the_card(cuda):
    """CLIP's BatchNorm on a bf16 channels-last activation: the f32 scale
    and shift stored straight into bf16 equal the f32 result cast
    afterwards, bit for bit, and keep the layout."""
    from safevla_tpu_torch.models.resnet import FrozenBatchNorm

    gen = torch.Generator().manual_seed(0)
    bn = FrozenBatchNorm(256)
    with torch.no_grad():
        for t in (bn.weight, bn.bias, bn.running_mean):
            t.copy_(torch.randn(256, generator=gen))
        bn.running_var.copy_(torch.rand(256, generator=gen) + 0.5)
    bn = bn.to("cuda").requires_grad_(False)
    x = torch.randn(4, 256, 14, 24, generator=gen).to("cuda", torch.bfloat16)
    x = x.to(memory_format=torch.channels_last)
    y = bn(x)
    scale, shift = bn._scale_shift()
    assert y.dtype == torch.bfloat16 and y.is_contiguous(memory_format=torch.channels_last)
    assert torch.equal(y, torch.addcmul(shift, x, scale).to(torch.bfloat16))


@pytest.mark.gpu
def test_two_gloo_ranks_on_the_card_update_as_one(cuda, tmp_path):
    """Learner.update of a small f32 policy (head dim 64: the kernels run) on
    2 gloo ranks sharing cuda:0, each with its half of a 4 x 8 window,
    against the 1-rank update of the whole window on the card: metrics at
    1e-4, the step the global batch, the weights at 1e-5 but where Adam's
    step went another way. The GEMMs run over 2 rows a rank against 4, so
    f32 sums fall in another order, and a weight whose gradient is zero up
    to that rounding in an epoch may take its step (lr * m / sqrt(v)) the
    other way, as tests/test_torch_offline.py allows for AdamW's first step:
    beyond 1e-5 only where the 1-rank run's gradient is below 1e-3 of the
    largest (its RMS over the epochs, from Adam's second moment), in under
    0.01% of the weights, and never by more than the epochs' reach,
    2 * update_repeats * lr."""
    import torch_parallel_ranks as ranks
    from safevla_tpu_torch.algo.learner import Learner
    from safevla_tpu_torch.config import ModelConfig

    vit_kw = dict(embed_dim=128, depth=2, num_heads=2, img_height=28, img_width=42)
    model = dict(hidden_size=128, num_tx_layers=2, num_tx_heads=2, goal_dims=128, text_embed_size=128,
                 combiner_layers=3, combiner_heads=2, combiner_ffn_dim=256, dino_compressor_hidden_out_dims=(128, 128),
                 vision_backbone="gpu_small", vision_feature_dim=128, image_size=(28, 42), max_steps=8,
                 text_max_tokens=8, compute_dtype="float32", fusion_chunk=8)
    payload = {"model": {**dataclasses.asdict(ModelConfig()), **model}, "vit": "gpu_small", "vit_kw": vit_kw,
               "seed": 7, "cost": 3.0, "stage": 1, "overrides": {"ppo": {"normalize_advantage": True}},
               "device": "cuda:0", "backend": "gloo", "dp": 2, "mdl": 1, "kinds": ["update"]}
    payload["batch"] = ranks.window(payload["model"], 4, 8, seed=12)
    got = ranks.run_ranks("learner_update", 2, payload, tmp_path, timeout=300)
    ranks._register_vit(payload)
    cfg = ranks._config(payload)
    learner = Learner(ranks.seeded_policy(cfg, payload, torch.device("cuda")), cfg)
    ts, metrics = learner.update(learner.init(), payload["batch"], 3.0, 1)
    want = ranks._update_result(learner, ts, metrics)
    reach = 2 * cfg.ppo.update_repeats * cfg.ppo.lr
    bc2 = 1 - 0.999 ** ts.opt_state.count  # adam_step's b2
    rms = {k: (nu / bc2).sqrt().cpu().numpy() for k, nu in zip(ts.tower_params, ts.opt_state.nu)}
    floor = 1e-3 * max(g.max() for g in rms.values())
    for r in got:
        assert r["update"]["step"] == want["step"] == 32
        for k, v in want["metrics"].items():
            assert abs(r["update"]["metrics"][k] - v) <= 1e-4 * (1 + abs(v)), k
        diffs = {f"{t}.{k}": np.abs(r["update"]["towers"][t][k] - v)
                 for t, sd in enumerate(want["towers"]) for k, v in sd.items()}
        beyond = sum(int((d > 1e-5).sum()) for d in diffs.values())
        assert beyond < 1e-4 * sum(d.size for d in diffs.values()), beyond
        for k, d in diffs.items():
            flip = d > 1e-5
            if flip.any():  # a trained weight, with a gradient that is zero up to rounding
                assert k in rms and np.all(rms[k][flip] < floor), (k, rms[k][flip].max() / floor * 1e-3)
        worst = max(diffs, key=lambda k: diffs[k].max())
        assert diffs[worst].max() <= reach, (worst, diffs[worst].max())


@pytest.mark.gpu
def test_merged_action_fetch_window_matches_the_per_group_window_on_the_card(cuda, monkeypatch):
    """`SAFEVLA_MERGED_FETCH=1` on the card (one concat, one pinned copy and
    one event per time step): two windows of a small policy whose sites take
    the kernels equal the per-group fetch's windows bit for bit, with one
    blocking fetch per time step instead of one per (group, step)."""
    import random

    from safevla_tpu_torch.envs.fake_tasks import make_sampler_factory
    from safevla_tpu_torch.models.actor_critic import SafeVLAPolicy
    from safevla_tpu_torch.rollout.env_pool import EnvPool
    from safevla_tpu_torch.rollout.runner import RolloutRunner

    cfg = _small_config("linear")
    cfg.train.num_train_processes = 4
    policy = SafeVLAPolicy(cfg.model, device="cuda", generator=torch.Generator().manual_seed(0))
    runs = {}
    for merged in ("0", "1"):
        monkeypatch.setenv("SAFEVLA_MERGED_FETCH", merged)
        random.seed(3)
        np.random.seed(3)
        pool = EnvPool(make_sampler_factory(max_steps=5, image_hw=(28, 42)), num_streams=4, num_workers=0)
        runner = RolloutRunner(policy, cfg, pool, seed=0, overlap_groups=2)
        before = fa.attention_qkv.launches
        runs[merged] = [runner.collect(6)[0] for _ in range(2)], runner.timer.counts["action_fetch"]
        assert fa.attention_qkv.launches > before
        assert runner._merged_fetch == (merged == "1")
        pool.close()
    (per_group, fetches_pg), (merged, fetches_m) = runs["0"], runs["1"]
    assert (fetches_pg, fetches_m) == (2 * 6 * 2, 2 * 6)
    for w in range(2):
        for k, v in per_group[w].items():
            assert torch.equal(merged[w][k], v), k


def _exp_attn_bwd_tool():
    """tools/torch_exp_attn_bwd.py, loaded by its path (it imports no JAX)."""
    import importlib.util
    import pathlib

    path = pathlib.Path(__file__).resolve().parent.parent / "tools" / "torch_exp_attn_bwd.py"
    spec = importlib.util.spec_from_file_location("torch_exp_attn_bwd", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# (B, S, H, Dh): the TPU tool's shape, row 2's two update shapes (fusion,
# SigLIP fusion), S not a multiple of 16, the other head dims, S at the
# kernel's largest at head dim 64
MMONLY_CASES = [(384, 201, 8, 64), (128, 208, 8, 64), (128, 240, 8, 64), (3, 37, 2, 64),
                (2, 65, 8, 16), (2, 100, 4, 32), (2, 48, 2, 128), (2, 448, 6, 64)]
# the kernel's edges at head dim 64: S on and just past its 64-row tiles
# (the last tile pulled back over the one before), and its persistent walk:
# one item past the 132 SMs (B=133, H=1), fewer items than SMs; the largest
# S at head dims 16, 32 and 128 (4 plane slots, no next item in flight)
MMONLY_EDGE_CASES = [(2, 64, 2, 64), (2, 65, 2, 64), (2, 128, 2, 64), (2, 129, 2, 64),
                     (2, 193, 2, 64), (2, 256, 2, 64), (133, 201, 1, 64), (1, 208, 2, 64),
                     (1, 1808, 2, 16), (1, 896, 2, 32), (1, 224, 2, 128)]


@pytest.mark.gpu
@pytest.mark.parametrize("b,s,h,dh", MMONLY_CASES + MMONLY_EDGE_CASES)
def test_exp_attn_bwd_mmonly_kernel_matches_plain_version(cuda, b, s, h, dh):
    """csrc/exp_attn_bwd.cu against `mmonly_reference` within 1e-2 of the
    largest |value| (a bf16 rounding of pb or dsb that falls the other way),
    one launch a call, the same bits twice."""
    tool = _exp_attn_bwd_tool()
    qkv, g, _ = tool.inputs(b, s, h, dh, seed=s)
    before = tool.mmonly.launches
    got, again = tool.mmonly(qkv, g, h), tool.mmonly(qkv, g, h)
    want = tool.mmonly_reference(qkv, g, h)
    assert tool.mmonly.launches == before + 2
    assert got.shape == want.shape and torch.isfinite(got).all()
    assert torch.equal(got, again)
    magnitude = want.float().abs().max().item()
    assert magnitude > 0
    diff = (got.float() - want.float()).abs()
    per = {part: diff[..., i * h * dh : (i + 1) * h * dh].max().item() for i, part in enumerate(("dq", "dk", "dv"))}
    assert max(per.values()) <= tool.TOL_REL * magnitude, (per, magnitude)


@pytest.mark.gpu
def test_exp_attn_bwd_mmonly_refuses_what_it_does_not_take(cuda):
    tool = _exp_attn_bwd_tool()
    qkv, g, _ = tool.inputs(2, 32, 2, 64)
    with pytest.raises(ValueError, match="bfloat16"):
        tool.mmonly(qkv.float(), g.float(), 2)
    odd, g_odd, _ = tool.inputs(2, 32, 2, 48)
    with pytest.raises(ValueError, match="head dims"):
        tool.mmonly(odd, g_odd, 2)
    long, g_long, _ = tool.inputs(1, 449, 2, 64)
    with pytest.raises(ValueError, match="S up to 448"):
        tool.mmonly(long, g_long, 2)


@pytest.mark.gpu
def test_exp_attn_bwd_library_runs_wgmma_and_tma(cuda):
    """The built exp_attn_bwd library's SASS holds warpgroup products (HGMMA)
    and TMA tile loads (UTMALDG): the design is in the machine code."""
    import pathlib
    import subprocess

    from safevla_tpu_torch.ops import _build

    _build.build(["exp_attn_bwd"])
    cuobjdump = pathlib.Path(_build.nvcc_path()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", str(_build.library_path("exp_attn_bwd"))],
                          capture_output=True, text=True, check=True, timeout=300).stdout
    assert "HGMMA" in sass and "UTMALDG" in sass


@pytest.mark.gpu
def test_exp_attn_bwd_library_refuses_past_mmonly_max_s(cuda):
    """The kernel's own shared-memory check (4 plane slots with their
    barriers) and the wrapper's `mmonly_max_s` draw one line at every head
    dim: the C entry runs S = mmonly_max_s(dh) and returns
    cudaErrorInvalidValue 16 rows past it."""
    import math

    tool = _exp_attn_bwd_tool()
    c = tool._C or tool._bind()
    for dh in fa.KERNEL_HEAD_DIMS:
        top = tool.mmonly_max_s(dh)
        for s in (top, top + 16):
            qkv, g, _ = tool.inputs(1, s, 1, dh)
            dqkv = torch.empty_like(qkv)
            args = (qkv.data_ptr(), g.data_ptr(), dqkv.data_ptr(), 1, s, 1, dh, qkv.stride(0), qkv.stride(1),
                    1.0 / math.sqrt(dh), torch.cuda.current_stream().cuda_stream)
            if s == top:
                c.exp_attn_bwd_mmonly(*args)
                torch.cuda.synchronize()
                assert torch.isfinite(dqkv.float()).all(), dh
            else:
                with pytest.raises(RuntimeError, match=r"\(cudaError 1\)"):
                    c.exp_attn_bwd_mmonly(*args)
