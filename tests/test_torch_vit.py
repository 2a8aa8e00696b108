"""Port DinoViT vs the JAX DinoViT, both in f32 at a tiny size.

The weights come from the JAX module's init, perturbed with seeded noise so
that LayerScale (init 1e-5) does not hide the blocks, and are carried over
by `from_jax.vit_state_dict`. atol 1e-4 on the pooled f32 features. The tiny
ViT (32 wide, 2 heads of 16) takes the JAX XLA attention path on the CPU,
the same math as the Pallas kernel in f32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from safevla_tpu.models import vit as jvit
from safevla_tpu_torch.models import vit as pvit
from safevla_tpu_torch.models.from_jax import vit_state_dict


def _perturb(tree, seed, scale=0.2):
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda x: (np.asarray(x) + scale * rng.standard_normal(np.shape(x))).astype(np.float32),
        tree,
    )


@pytest.mark.parametrize(
    "kw,in_width",
    [
        # 2x3 patches + CLS = 7 tokens, padded to 16 (key_lens 7); the input
        # is 4 px wider than img_width, so the centre crop runs
        (dict(embed_dim=32, depth=2, num_heads=2, img_height=28, img_width=42), 46),
        # no CLS token, no LayerScale (the SigLIP trunk's options)
        (
            dict(embed_dim=32, depth=1, num_heads=2, img_height=28, img_width=28,
                 layerscale=False, use_cls_token=False),
            28,
        ),
    ],
)
def test_vit_matches_jax_f32(kw, in_width):
    jcfg = jvit.DinoViTConfig(patch_size=14, dtype=jnp.float32, **kw)
    pcfg = pvit.DinoViTConfig(patch_size=14, dtype=torch.float32, **kw)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 28, in_width, 3)).astype(np.float32)
    jmod = jvit.DinoViT(jcfg)
    params = _perturb(jmod.init(jax.random.PRNGKey(0), jnp.asarray(x)), seed=1)
    want = np.asarray(jmod.apply(params, jnp.asarray(x)))

    pmod = pvit.DinoViT(pcfg)
    sd = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in vit_state_dict(params).items()}
    pmod.load_state_dict(sd, strict=True)
    with torch.no_grad():
        got = pmod(torch.from_numpy(x))
    assert got.shape == want.shape == (3, 7, 12, 32) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4)


def test_pool_matrix_and_bf16_forward():
    np.testing.assert_array_equal(
        pvit.adaptive_pool_matrix(27, 12), jvit.adaptive_pool_matrix(27, 12)
    )
    cfg = pvit.DinoViTConfig(embed_dim=32, depth=1, num_heads=2, img_height=28, img_width=42)
    mod = pvit.DinoViT(cfg)
    assert mod.blocks[0].attn.qkv.weight.dtype == torch.bfloat16
    assert mod.blocks[0].mlp.approximate == "tanh"  # tanh GELU in bf16, erf in f32
    with torch.no_grad():
        out = mod(torch.randn(2, 28, 42, 3))
    assert out.dtype == torch.float32 and torch.isfinite(out).all()
