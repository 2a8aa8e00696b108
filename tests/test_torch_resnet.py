"""Port ClipResNet vs the JAX one, and `import_clip_resnet`.

CLIP's modified ResNet at width 8, layers (1, 1, 1, 1), with numpy-seeded
weights and BatchNorm statistics away from the identity, carried by
`from_jax.resnet_state_dict`; at 224x384 (the last map is (7, 12): no pool)
and at 96x160 (a (3, 5) map adaptive-pooled to (7, 12)). f32 at atol 1e-4;
bf16 (convs in bf16, the f32 BatchNorm then cast back, as in JAX) as a
relative L2 error within 2e-2: XLA and oneDNN sum the convolutions in other
orders, so a bf16 rounding of an activation may fall the other way. The
importer: a CLIP-named trunk (tests/test_resnet.py's oracle) through the
port's `import_clip_resnet` (with and without `visual.`, an `attnpool.*`
head and BatchNorm's `num_batches_tracked` present) and JAX's importer
into JAX's module give equal outputs, and JAX's importer reads a port
`state_dict()` back to the same tree."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn as tnn

from safevla_tpu.models import resnet as jres
from safevla_tpu_torch.models import image_encoders as pie
from safevla_tpu_torch.models import resnet as pres
from safevla_tpu_torch.models.from_jax import resnet_state_dict
from test_resnet import _TorchClipTrunk

WIDTH, LAYERS = 8, (1, 1, 1, 1)


def random_resnet_tree(shapes, seed, scale=0.2):
    """Conv kernels N(0, 1/fan_in); BatchNorm scale 1 + noise, bias and mean
    noise, var 1 + |noise| (positive)."""
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = str(path[-1].key)
        x = rng.standard_normal(s.shape).astype(np.float32)
        if name == "kernel":  # (kh, kw, in, out)
            return x / np.float32(np.sqrt(np.prod(s.shape[:-1])))
        if name in ("scale", "var"):
            return np.float32(1.0) + np.float32(scale) * (np.abs(x) if name == "var" else x)
        return np.float32(scale) * x

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _pair(dtype: str):
    jmod = jres.ClipResNet(jres.ClipResNetConfig(WIDTH, LAYERS, dtype=jnp.dtype(dtype)))
    shapes = jax.eval_shape(jmod.init, jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)))
    params = random_resnet_tree(shapes, seed=7)
    port = pres.ClipResNet(pres.ClipResNetConfig(WIDTH, LAYERS, dtype=getattr(torch, dtype)))
    sd = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in resnet_state_dict(params).items()}
    port.load_state_dict(sd, strict=True)
    return jmod, params, port


@pytest.mark.parametrize("hw", [(224, 384), (96, 160)], ids=["no_pool", "pooled"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_clip_resnet_matches_jax(dtype, hw):
    jmod, params, port = _pair(dtype)
    x = np.random.default_rng(1).normal(size=(2, *hw, 3)).astype(np.float32)
    want = np.asarray(jax.jit(jmod.apply)(params, x))
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, 7, 12, port.cfg.out_dim) and got.dtype == np.float32
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=1e-4)
    else:
        assert np.linalg.norm(got - want) <= 2e-2 * np.linalg.norm(want)


def _oracle():
    torch.manual_seed(0)
    oracle = _TorchClipTrunk(width=WIDTH, layers=LAYERS).eval()
    for m in oracle.modules():  # BatchNorm statistics away from the identity
        if isinstance(m, tnn.BatchNorm2d):
            m.running_mean.uniform_(-0.3, 0.3)
            m.running_var.uniform_(0.5, 1.5)
            m.weight.data.uniform_(0.5, 1.5)
            m.bias.data.uniform_(-0.3, 0.3)
    return oracle


@pytest.mark.parametrize("prefix", ["", "visual."])
def test_import_clip_resnet_matches_jax_importer(prefix):
    oracle = _oracle()
    upstream = {f"{prefix}{k}": v for k, v in oracle.state_dict_clip_naming().items()}
    upstream[f"{prefix}attnpool.c_proj.weight"] = torch.zeros(4, 4)  # the head neither reads
    upstream[f"{prefix}bn1.num_batches_tracked"] = torch.tensor(3)
    cfg_np = dict(width=WIDTH, layers=LAYERS)
    port = pres.ClipResNet(pres.ClipResNetConfig(dtype=torch.float32, **cfg_np))
    port.load_state_dict(pres.import_clip_resnet(upstream, port.cfg), strict=True)
    jcfg = jres.ClipResNetConfig(dtype=jnp.float32, **cfg_np)
    jparams = jres.import_clip_resnet(upstream, jcfg)
    x = np.random.default_rng(2).normal(size=(2, 224, 384, 3)).astype(np.float32)
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jax.jit(jres.ClipResNet(jcfg).apply)(jparams, x)), atol=1e-4)
    back = jres.import_clip_resnet(port.state_dict(), jcfg)
    for (path, a), (_, b) in zip(jax.tree_util.tree_leaves_with_path(back), jax.tree_util.tree_leaves_with_path(jparams)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=jax.tree_util.keystr(path))


def test_registry_builds_the_resnet_under_both_names():
    assert pie.REFERENCE_ENCODER_ALIASES["ClipResNet50"] == "clip_rn50"
    assert pie.encoder_feature_dim("ClipResNet50") == pie.encoder_feature_dim("clip_rn50") == 2048
    assert pie.encoder_feature_dim("siglip_vitb16_256") == 768
    enc = pie.build_image_encoder("ClipResNet50")
    assert isinstance(enc, pres.ClipResNet) and enc.pool_grid == (7, 12) and enc.cfg.layers == (3, 4, 6, 3)
    # CLIP's `visual.` names, BatchNorm's statistics included
    assert {"conv1.weight", "bn3.running_var", "layer1.0.downsample.0.weight", "layer4.2.bn3.weight"} <= set(
        enc.state_dict()
    )
    with pytest.raises(KeyError):
        pie.build_image_encoder("nope")
