"""Port T5Encoder vs the JAX T5Encoder, both in f32 at a small size.

Checks the unscaled attention, the relative-position bias owned by block 0
and reused by the others, the -1e9 pad mask, and the zeroed pad outputs.
atol 1e-4 on the f32 hidden states."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from safevla_tpu.models import t5 as jt5
from safevla_tpu_torch.models import t5 as pt5
from safevla_tpu_torch.models.from_jax import t5_state_dict

SMALL = dict(vocab_size=97, d_model=32, d_kv=8, d_ff=64, num_layers=3, num_heads=4)


def _perturb(tree, seed, scale=0.1):
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda x: (np.asarray(x) + scale * rng.standard_normal(np.shape(x))).astype(np.float32),
        tree,
    )


def test_t5_encoder_matches_jax_f32():
    rng = np.random.default_rng(0)
    tokens = rng.integers(3, SMALL["vocab_size"], (3, 12)).astype(np.int32)
    mask = np.zeros((3, 12), bool)
    for i, n in enumerate((12, 5, 1)):
        mask[i, :n] = True
    tokens[~mask] = 0
    jmod = jt5.T5Encoder(jt5.T5Config(dtype=jnp.float32, **SMALL))
    params = _perturb(jmod.init(jax.random.PRNGKey(0), jnp.asarray(tokens), jnp.asarray(mask)), 1)
    want = np.asarray(jmod.apply(params, jnp.asarray(tokens), jnp.asarray(mask)))

    pmod = pt5.T5Encoder(pt5.T5Config(dtype=torch.float32, **SMALL))
    sd = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in t5_state_dict(params).items()}
    pmod.load_state_dict(sd, strict=True)
    with torch.no_grad():
        got = pmod(torch.from_numpy(tokens), torch.from_numpy(mask))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4)
    assert not got[~torch.from_numpy(mask)].any()  # pads are zeroed


def test_relative_position_bucket_matches_jax():
    pos = np.arange(40)
    rel = pos[None, :] - pos[:, None]
    np.testing.assert_array_equal(
        pt5.relative_position_bucket(rel), jt5.relative_position_bucket(rel)
    )
