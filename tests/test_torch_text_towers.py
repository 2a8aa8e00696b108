"""Port SigLIPTextEncoder vs the JAX one, and the SigLIP importers.

The same numpy-seeded weights (every leaf of the JAX tree, norms included,
away from its init constant) go to both sides through
`from_jax.text_tower_state_dict`; tokens with a partial (right-padded) mask
and ids at or above the vocabulary (the hash tokenizer's 32128 ids against
the tower's 32000 rows: JAX's gather clamps them, the port clamps them
too). f32 at atol 1e-4. bf16 (the port stores the linear weights in bf16,
the cast JAX applies at every use) as a relative L2 error within 2e-2: the
two frameworks round at other points (XLA rounds a Dense's product before
its bias add and each op of the GELU; torch rounds once), and the final LN
divides those roundings of the residual stream by its spread, so single
elements move by a few bf16 ulps of the unit-scale output. The importers:
an open_clip-named TextTransformer and a timm-named SigLIP trunk (the oracles of
tests/test_siglip.py) through the port's `import_siglip_text` /
`import_siglip_trunk` and through JAX's importers into JAX's modules give
equal outputs, bare or prefixed as in an open_clip checkpoint, and JAX's
importers read a port `state_dict()` back."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from safevla_tpu.models import convert as jconvert
from safevla_tpu.models import text_towers as jtt
from safevla_tpu.models import vit as jvit
from safevla_tpu_torch.models import convert as pconvert
from safevla_tpu_torch.models import text_towers as ptt
from safevla_tpu_torch.models import vit as pvit
from safevla_tpu_torch.models.from_jax import text_tower_state_dict, vit_state_dict
from test_siglip import _ClipTextTower, _TimmSigLIPTrunk

VOCAB, D, HEADS, LAYERS, CTX = 128, 32, 2, 2, 8


def random_tree(shapes, seed, scale=0.05):
    """Numpy weights for every leaf: dense kernels N(0, 1/fan_in), norm
    scales 1 + noise, every other leaf noise."""
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = str(path[-1].key)
        x = rng.standard_normal(s.shape).astype(np.float32)
        if name == "kernel":
            return x / np.float32(np.sqrt(s.shape[-2]))
        if name == "scale":
            return np.float32(1.0) + np.float32(scale) * x
        return np.float32(scale) * x

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _pair(dtype: str):
    jcfg = jtt.TextTowerConfig(VOCAB, D, LAYERS, HEADS, max_tokens=CTX, dtype=jnp.dtype(dtype))
    jmod = jtt.SigLIPTextEncoder(jcfg)
    shapes = jax.eval_shape(jmod.init, jax.random.PRNGKey(0), jnp.zeros((1, CTX), jnp.int32), jnp.ones((1, CTX), bool))
    params = random_tree(shapes, seed=3)
    port = ptt.SigLIPTextEncoder(ptt.TextTowerConfig(VOCAB, D, LAYERS, HEADS, max_tokens=CTX, dtype=getattr(torch, dtype)))
    port.load_state_dict({k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in text_tower_state_dict(params).items()})
    return jmod, params, port


def _tokens(seed, b=3):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, VOCAB, (b, CTX)).astype(np.int32)
    mask = np.arange(CTX)[None] < np.array([CTX, 5, 2])[:b, None]  # right-padded
    return tokens, mask


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_text_tower_matches_jax(dtype):
    jmod, params, port = _pair(dtype)
    tokens, mask = _tokens(seed=4)
    want = np.asarray(jax.jit(jmod.apply)(params, tokens, mask))
    with torch.no_grad():
        got = port(torch.from_numpy(tokens), torch.from_numpy(mask))
    assert got.dtype == torch.float32 and got.shape == (3, CTX, D)
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), want, atol=1e-4)
    else:
        assert np.linalg.norm(got.numpy() - want) <= 2e-2 * np.linalg.norm(want)
    assert not got.numpy()[~mask].any()  # masked positions are zero


def test_ids_past_the_vocabulary_clamp_as_in_jax():
    """Ids >= vocab (as the 32128-id hash tokenizer gives a 32000-row tower)
    read the last row, as JAX's gather does; nn.Embedding would raise."""
    jmod, params, port = _pair("float32")
    tokens, mask = _tokens(seed=5)
    tokens[0, :4] = [VOCAB, VOCAB + 7, 32127, VOCAB - 1]
    tokens[1, 1] = VOCAB + 1
    want = np.asarray(jax.jit(jmod.apply)(params, tokens, mask))
    with torch.no_grad():
        got = port(torch.from_numpy(tokens), torch.from_numpy(mask)).numpy()
        clamped = port(torch.from_numpy(np.minimum(tokens, VOCAB - 1)), torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4)
    np.testing.assert_array_equal(got, clamped)


@pytest.mark.parametrize("prefix", ["", "text."])
def test_import_siglip_text_matches_jax_importer(prefix):
    torch.manual_seed(0)
    oracle = _ClipTextTower(vocab=VOCAB, d=D, h=HEADS, depth=LAYERS, ctx=CTX).eval()
    upstream = {f"{prefix}{k}": v for k, v in oracle.state_dict().items()}
    upstream["logit_scale"] = torch.zeros(())  # an unrelated open_clip key
    port = ptt.SigLIPTextEncoder(ptt.TextTowerConfig(VOCAB, D, LAYERS, HEADS, max_tokens=CTX, dtype=torch.float32))
    port.load_state_dict(pconvert.import_siglip_text(upstream, num_layers=LAYERS), strict=True)
    jmod = jtt.SigLIPTextEncoder(jtt.TextTowerConfig(VOCAB, D, LAYERS, HEADS, max_tokens=CTX, dtype=jnp.float32))
    jparams = jconvert.import_siglip_text(upstream, num_layers=LAYERS)
    tokens, mask = _tokens(seed=6)
    with torch.no_grad():
        got = port(torch.from_numpy(tokens), torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(got, np.asarray(jmod.apply(jparams, tokens, mask)), atol=1e-4)
    # JAX's importer reads the port's state dict back to the same tree
    back = jconvert.import_siglip_text(port.state_dict(), num_layers=LAYERS)
    for (path, a), (_, b) in zip(jax.tree_util.tree_leaves_with_path(back), jax.tree_util.tree_leaves_with_path(jparams)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("prefix", ["", "visual.trunk."])
def test_import_siglip_trunk_matches_jax_importer(prefix):
    """A timm-named patch-only trunk (16x16 patches on a 32x48 image: a 2x3
    grid, no CLS, no LayerScale) into the port's DinoViT and JAX's, f32."""
    torch.manual_seed(0)
    oracle = _TimmSigLIPTrunk().eval()
    upstream = {f"{prefix}{k}": v for k, v in oracle.state_dict().items()}
    kw = dict(patch_size=16, embed_dim=32, depth=2, num_heads=2, img_height=32, img_width=48,
              layerscale=False, use_cls_token=False)
    port = pvit.DinoViT(pvit.DinoViTConfig(dtype=torch.float32, **kw), pool_grid=oracle.grid)
    port.load_state_dict(pconvert.import_siglip_trunk(upstream, depth=2), strict=True)
    jparams = jconvert.import_siglip_trunk(upstream, depth=2)
    jmod = jvit.DinoViT(jvit.DinoViTConfig(dtype=jnp.float32, **kw), pool_grid=oracle.grid)
    x = np.random.default_rng(1).normal(size=(2, 32, 48, 3)).astype(np.float32)
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jmod.apply(jparams, x)), atol=1e-4)
    # the port's state dict is the JAX tree's, leaf for leaf
    want = vit_state_dict(jparams)
    sd = port.state_dict()
    assert sd.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(sd[k].numpy(), want[k], err_msg=k)
    back = jconvert.import_siglip_trunk(sd, depth=2)
    for (path, a), (_, b) in zip(jax.tree_util.tree_leaves_with_path(back), jax.tree_util.tree_leaves_with_path(jparams)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=jax.tree_util.keystr(path))
