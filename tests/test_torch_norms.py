"""Port CompatLayerNorm vs the JAX CompatLayerNorm and flax nn.LayerNorm.

Same f32 inputs and parameters on both sides; atol 1e-4 in f32 (the same
fast-variance formula, summed in another order)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from safevla_tpu.models.norms import CompatLayerNorm as JaxCompatLayerNorm
from safevla_tpu_torch.models.norms import CompatLayerNorm


def _case(seed, shape=(4, 7, 48)):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(shape) * 3 + 1).astype(np.float32)
    scale = (1 + 0.2 * rng.standard_normal(shape[-1])).astype(np.float32)
    bias = (0.2 * rng.standard_normal(shape[-1])).astype(np.float32)
    return x, scale, bias


def _port(x, scale, bias, out_dtype=None):
    ln = CompatLayerNorm(x.shape[-1], out_dtype=out_dtype)
    with torch.no_grad():
        ln.weight.copy_(torch.from_numpy(scale))
        ln.bias.copy_(torch.from_numpy(bias))
        return ln(torch.from_numpy(x))


@pytest.mark.parametrize("seed", [0, 1])
def test_compat_layer_norm_matches_jax(seed):
    x, scale, bias = _case(seed)
    want = JaxCompatLayerNorm().apply({"params": {"scale": scale, "bias": bias}}, jnp.asarray(x))
    got = _port(x, scale, bias)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


def test_compat_layer_norm_matches_flax_layer_norm():
    """The towers' adapters use flax nn.LayerNorm(dtype=f32), eps 1e-6."""
    x, scale, bias = _case(2, (3, 84, 64))
    want = nn.LayerNorm(dtype=jnp.float32).apply(
        {"params": {"scale": scale, "bias": bias}}, jnp.asarray(x)
    )
    np.testing.assert_allclose(_port(x, scale, bias).numpy(), np.asarray(want), atol=1e-4)


def test_compat_layer_norm_out_dtype_and_eps():
    x, scale, bias = _case(3)
    got = _port(x, scale, bias, out_dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16
    # eps is 1e-6 (torch's nn.LayerNorm default is 1e-5)
    # (a zero-mean row of variance 1e-6 normalises to +-0.71 with eps 1e-6,
    # to +-0.30 with eps 1e-5)
    ln = CompatLayerNorm(8)
    assert ln.eps == 1e-6
    row = torch.tensor([[1e-3, -1e-3] * 4])
    want = JaxCompatLayerNorm().apply(
        {"params": {"scale": np.ones(8, np.float32), "bias": np.zeros(8, np.float32)}},
        jnp.asarray(row.numpy()),
    )
    np.testing.assert_allclose(ln(row).detach().numpy(), np.asarray(want), atol=1e-4)
