"""Port NonTxVisualEncoder vs the JAX one.

tests/test_visual_encoders.py's small config (compressor (16, 8), text
adapter 8, combiner (12, 6), out 32) on two cameras of (B=2, T=3, 7, 12,
24) grids and a (2, 5, 20) text sequence, with numpy-seeded weights (norms
away from 1) carried by `from_jax.nontx_state_dict`. f32 at atol 1e-4 for
both outputs; bf16 (flax casts the f32 weights at every use, the port too)
as a relative L2 error within 2e-2. One set of channel-conv weights, under
the reference's names, serves both cameras."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from safevla_tpu.models import visual_encoders as jve
from safevla_tpu_torch.models import visual_encoders as pve
from safevla_tpu_torch.models.from_jax import nontx_state_dict
from test_torch_text_towers import random_tree

SMALL = dict(compressor_hidden_dims=(16, 8), text_adapter_output_dim=8,
             image_text_combiner_hidden_dims=(12, 6), final_out_dim=32)


def _inputs():
    rng = np.random.default_rng(0)
    frames = {c: rng.normal(size=(2, 3, 7, 12, 24)).astype(np.float32) for c in ("rgb_manip", "rgb_nav")}
    return frames, rng.normal(size=(2, 5, 20)).astype(np.float32)


def _pair(dtype: str):
    frames, text = _inputs()
    jmod = jve.NonTxVisualEncoder(jve.NonTxEncoderConfig(dtype=jnp.dtype(dtype), **SMALL))
    params = random_tree(jax.eval_shape(jmod.init, jax.random.PRNGKey(0), frames, text), seed=8)
    port = pve.NonTxVisualEncoder(pve.NonTxEncoderConfig(dtype=getattr(torch, dtype), **SMALL), visual_dim=24, text_dim=20)
    port.load_state_dict({k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in nontx_state_dict(params).items()})
    return jmod, params, port


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_nontx_encoder_matches_jax(dtype):
    jmod, params, port = _pair(dtype)
    frames, text = _inputs()
    want = jax.jit(jmod.apply)(params, frames, text)
    with torch.no_grad():
        got = port({c: torch.from_numpy(f) for c, f in frames.items()}, torch.from_numpy(text))
    for g, w, shape in zip(got, want, ((2, 3, 32), (2, 5, 32))):
        g, w = g.numpy(), np.asarray(w)
        assert g.shape == w.shape == shape and g.dtype == np.float32
        if dtype == "float32":
            np.testing.assert_allclose(g, w, atol=1e-4)
        else:
            assert np.linalg.norm(g - w) <= 2e-2 * np.linalg.norm(w)


def test_nontx_encoder_names_follow_the_reference():
    _, _, port = _pair("float32")
    names = set(port.state_dict())
    assert {"visual_compressor.0.weight", "visual_compressor.2.bias", "image_text_combiner.0.weight",
            "text_adapter.1.weight", "text_adapter_for_combiner.0.weight", "final_adapter.0.weight"} <= names
    assert port.visual_compressor[0].weight.shape == (16, 24, 1, 1)
    assert port.final_adapter[0].weight.shape == (32, 2 * 7 * 12 * 6)
