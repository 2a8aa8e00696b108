"""The port's row LayerNorm (plain forward and backward, the autograd
Function, CompatLayerNorm) against the JAX package's Pallas LayerNorm in
interpret mode and its `jax.vjp`, and against the JAX CompatLayerNorm with
SAFEVLA_PALLAS_LN on and off.

Same inputs (numpy, from a seed) on both sides. Tolerances: f32 forward
atol 2e-6 (the same formula, sums in another order), f32 dx atol 1e-5,
dgamma / dbeta atol 1e-4 (sums over up to 40 rows of products of order 1);
bf16 outputs atol 2e-2 (one bf16 rounding of values of order 1 that may fall
the other way)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.checkpoint import checkpoint

from safevla_tpu.models.norms import CompatLayerNorm as JaxCompatLayerNorm
from safevla_tpu.ops.layer_norm import layer_norm_rows
from safevla_tpu_torch.models.norms import CompatLayerNorm, PlainLayerNorm
from safevla_tpu_torch.ops import layer_norm as ln

SHAPES = [(13, 384), (40, 512)]
# (x dtype, output dtype): the ViT and fusion norm1/2, the ViT's final norm,
# f32 configs
DTYPES = [("bfloat16", "bfloat16"), ("bfloat16", "float32"), ("float32", "float32")]
TOL = {"float32": 2e-6, "bfloat16": 2e-2}


def _case(r, d, seed):
    rng = np.random.default_rng(seed)
    x = (3 * rng.standard_normal((r, d)) + 1).astype(np.float32)
    gamma = (1 + 0.2 * rng.standard_normal(d)).astype(np.float32)
    beta = (0.2 * rng.standard_normal(d)).astype(np.float32)
    g = rng.standard_normal((r, d)).astype(np.float32)
    return x, gamma, beta, g


def _pt(a, dtype):
    return torch.from_numpy(a).to(getattr(torch, dtype))


def _np(t):
    return t.detach().float().numpy()


@pytest.mark.parametrize("r,d", SHAPES)
@pytest.mark.parametrize("xd,od", DTYPES)
def test_plain_forward_matches_pallas_kernel(r, d, xd, od):
    x, gamma, beta, _ = _case(r, d, r + d)
    xj = jnp.asarray(x).astype(getattr(jnp, xd))
    want = layer_norm_rows(xj, gamma, beta, 1e-6, getattr(jnp, od), True)
    got = ln.layer_norm_fwd_reference(_pt(x, xd), torch.from_numpy(gamma), torch.from_numpy(beta), 1e-6, getattr(torch, od))
    assert got.dtype == getattr(torch, od)
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32), atol=TOL[od])


@pytest.mark.parametrize("r,d", SHAPES)
@pytest.mark.parametrize("xd,od", DTYPES)
def test_plain_backward_matches_pallas_vjp(r, d, xd, od):
    """g arrives in the output dtype (the cotangent of the forward)."""
    x, gamma, beta, g = _case(r, d, 7 * r + d)
    xj = jnp.asarray(x).astype(getattr(jnp, xd))
    gj = jnp.asarray(g).astype(getattr(jnp, od))
    _, vjp = jax.vjp(
        lambda a, b, c: layer_norm_rows(a, b, c, 1e-6, getattr(jnp, od), True),
        xj, jnp.asarray(gamma), jnp.asarray(beta),
    )
    wdx, wdg, wdb = vjp(gj)
    dx, dg, db = ln.layer_norm_bwd_reference(_pt(x, xd), torch.from_numpy(gamma), _pt(g, od))
    assert dx.dtype == getattr(torch, xd) and dg.dtype == db.dtype == torch.float32
    np.testing.assert_allclose(_np(dx), np.asarray(wdx, np.float32), atol=1e-5 if xd == "float32" else 2e-2)
    np.testing.assert_allclose(_np(dg), np.asarray(wdg), atol=1e-4)
    np.testing.assert_allclose(_np(db), np.asarray(wdb), atol=1e-4)


@pytest.mark.parametrize("xd,od", DTYPES)
def test_autograd_function_matches_pallas_vjp(xd, od):
    """`layer_norm` on a (4, 10, 512) tensor (rows flattened) through the
    autograd Function, also under torch.utils.checkpoint's recompute (as
    forward_seq runs its fusion chunks): output and gradients of x, gamma
    and beta as the JAX custom VJP's."""
    x, gamma, beta, g = _case(40, 512, 3)
    xj = jnp.asarray(x).astype(getattr(jnp, xd))
    gj = jnp.asarray(g).astype(getattr(jnp, od))
    y, vjp = jax.vjp(
        lambda a, b, c: layer_norm_rows(a, b, c, 1e-6, getattr(jnp, od), True),
        xj, jnp.asarray(gamma), jnp.asarray(beta),
    )
    want = [np.asarray(a, np.float32) for a in (y, *vjp(gj))]
    dx_tol = 1e-5 if xd == "float32" else 2e-2
    for recompute in (False, True):
        xt = _pt(x, xd).reshape(4, 10, 512).requires_grad_(True)
        gt, bt = (torch.from_numpy(a).requires_grad_(True) for a in (gamma, beta))
        fn = lambda a, b, c: ln.layer_norm(a, b, c, 1e-6, getattr(torch, od))
        out = checkpoint(fn, xt, gt, bt, use_reentrant=False) if recompute else fn(xt, gt, bt)
        out.backward(_pt(g, od).reshape(4, 10, 512))
        np.testing.assert_allclose(_np(out).reshape(40, 512), want[0], atol=TOL[od])
        np.testing.assert_allclose(_np(xt.grad).reshape(40, 512), want[1], atol=dx_tol)
        np.testing.assert_allclose(_np(gt.grad), want[2], atol=1e-4)
        np.testing.assert_allclose(_np(bt.grad), want[3], atol=1e-4)


@pytest.mark.parametrize("flag", ["0", "1"])
@pytest.mark.parametrize("r,d", SHAPES)
@pytest.mark.parametrize("xd,od", DTYPES)
def test_compat_layer_norm_matches_jax_with_the_flag_on_and_off(monkeypatch, flag, r, d, xd, od):
    """With SAFEVLA_PALLAS_LN=1 the JAX module runs the Pallas kernel
    (interpret mode), with 0 its plain code; the port's module, which has no
    such switch, matches both (on the CPU it runs the plain version)."""
    monkeypatch.setenv("SAFEVLA_PALLAS_LN", flag)
    x, gamma, beta, _ = _case(r, d, 11 * r + d)
    want = JaxCompatLayerNorm(out_dtype=getattr(jnp, od), interpret=True).apply(
        {"params": {"scale": gamma, "bias": beta}}, jnp.asarray(x).astype(getattr(jnp, xd))
    )
    mod = CompatLayerNorm(d, out_dtype=getattr(torch, od))
    with torch.no_grad():
        mod.weight.copy_(torch.from_numpy(gamma))
        mod.bias.copy_(torch.from_numpy(beta))
    before = ln.layer_norm.launches
    got = mod(_pt(x, xd).reshape(r, 1, d))
    assert ln.layer_norm.launches == before  # the CPU launches nothing
    np.testing.assert_allclose(_np(got).reshape(r, d), np.asarray(want, np.float32), atol=TOL[od])


def test_only_compat_layer_norm_takes_the_kernel_wrapper(monkeypatch):
    """CompatLayerNorm always goes through `ops.layer_norm.layer_norm` (the
    kernel on a CUDA tensor, the plain version on a CPU one; the card's side
    is `tests/test_torch_kernels_gpu.py`); the adapter norms (PlainLayerNorm)
    never do."""
    calls = []
    monkeypatch.setattr("safevla_tpu_torch.models.norms.layer_norm", lambda *a: calls.append(a[0].shape))
    CompatLayerNorm(128)(torch.zeros(2, 128))
    PlainLayerNorm(128)(torch.zeros(3, 128))
    assert calls == [(2, 128)]


@pytest.mark.parametrize("r", [1, 16, 128, 3328, 14336, 26624])
@pytest.mark.parametrize("max_blocks", [132, 264])
def test_backward_grid_covers_every_row_once(r, max_blocks):
    """The backward's blocks (`bwd_blocks`) with the kernel's share of rows
    per block, [b * R // blocks, (b + 1) * R // blocks): every row exactly
    once, no block without a row, never more blocks than fit on the card,
    and at up to 8 rows a block, every warp has a row (128 rows: 16 blocks
    of 8 warps)."""
    blocks = ln.bwd_blocks(r, max_blocks)
    assert 1 <= blocks <= max_blocks
    shares = [range(b * r // blocks, (b + 1) * r // blocks) for b in range(blocks)]
    rows = [i for share in shares for i in share]
    assert rows == list(range(r))
    assert min(len(s) for s in shares) >= 1
    if r <= max_blocks * ln.BWD_WARPS:
        assert max(len(s) for s in shares) <= ln.BWD_WARPS
