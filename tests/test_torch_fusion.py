"""Port FusionTransformer vs the JAX FusionTransformer, f32, small size.

Three post-LN layers: the first two take the packed-qkv attention path with
per-row key_lens, the last either all rows or only the CLS row
(out_rows=1). atol 1e-4 on the f32 outputs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from safevla_tpu.models import fusion as jfusion
from safevla_tpu_torch.models import fusion as pfusion
from safevla_tpu_torch.models.from_jax import _fusion_layer, _unstack

DIM, HEADS, LAYERS, FFN = 64, 4, 3, 128


def _perturb(tree, seed, scale=0.1):
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda x: (np.asarray(x) + scale * rng.standard_normal(np.shape(x))).astype(np.float32),
        tree,
    )


def _state_dict(params):
    p = params["params"]
    sd = {}
    for i in range(LAYERS - 1):
        sd.update(_fusion_layer(f"layers.{i}", _unstack(p["layers"], i)))
    sd.update(_fusion_layer(f"layers.{LAYERS - 1}", p["layer_last"]))
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}


@pytest.mark.parametrize("out_rows", [1, None])
def test_fusion_matches_jax_f32(out_rows):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 48, DIM)).astype(np.float32)
    key_lens = np.asarray([48, 37, 20], np.int32)
    jmod = jfusion.FusionTransformer(DIM, HEADS, LAYERS, FFN, dtype=jnp.float32)
    params = _perturb(jmod.init(jax.random.PRNGKey(0), jnp.asarray(x)), 1)
    want = np.asarray(
        jmod.apply(params, jnp.asarray(x), key_lens=jnp.asarray(key_lens), out_rows=out_rows)
    )
    pmod = pfusion.FusionTransformer(DIM, HEADS, LAYERS, FFN, dtype=torch.float32)
    pmod.load_state_dict(_state_dict(params), strict=True)
    with torch.no_grad():
        got = pmod(torch.from_numpy(x), torch.from_numpy(key_lens), out_rows=out_rows).numpy()
    assert got.shape == want.shape == (3, out_rows or 48, DIM)
    # query rows past key_lens are computed like any other row on both sides
    np.testing.assert_allclose(got, want, atol=1e-4)
