"""Port apply_augment (and normalize_images) vs the JAX functions.

Both sides get the same AugmentParams (the port cannot reproduce JAX PRNG
streams): the identity set, a set sampled by the port's own sampler, and
fixed sets covering the v1 branch and posterize. The JAX side runs its f32
geometry (SAFEVLA_AUGMENT_F32=1, set per test with monkeypatch); the port
always runs f32. atol 1e-4 on [0, 1] images."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from safevla_tpu.preprocessing import augment as jaug
from safevla_tpu.preprocessing import normalize as jnorm
from safevla_tpu_torch.preprocessing import augment as paug
from safevla_tpu_torch.preprocessing import normalize as pnorm


@pytest.fixture
def f32_geometry(monkeypatch):
    monkeypatch.setenv("SAFEVLA_AUGMENT_F32", "1")


def _images(seed, shape=(2, 2, 28, 42, 3)):
    return np.random.default_rng(seed).random(shape, dtype=np.float32)


def _both(images, params):
    want = jaug.apply_augment(
        jnp.asarray(images), jaug.AugmentParams(*[jnp.float32(v) for v in params])
    )
    got = paug.apply_augment(torch.from_numpy(images), params)
    return got.numpy(), np.asarray(want)


FIXED = [
    # v1-style: grayscale on, posterize to 7 bits, strong hue, no crop
    paug.AugmentParams(1.2, 0.8, 1.3, 0.15, 1.0, 0.4, 1.0, 0.5, 0.5, 7.0, 2.0, 1.0),
    # v2-style: 4-bit posterize, strong crop at a corner, sharpness off
    paug.AugmentParams(0.7, 1.3, 0.85, -0.04, 1.0, 1.9, 1.0540925, 1.0, 0.0, 4.0, 1.0, 0.0),
]


def test_identity_params(f32_geometry):
    images = _images(0)
    got, want = _both(images, paug.identity_augment_params())
    np.testing.assert_array_equal(got, images)
    np.testing.assert_allclose(got, want, atol=1e-4)


@pytest.mark.parametrize("version,seed", [("v2", 1), ("v2", 2), ("v1", 3)])
def test_sampled_params(f32_geometry, version, seed):
    params = paug.sample_augment_params(torch.Generator().manual_seed(seed), version=version)
    assert params.enabled == 1.0 and params.crop_zoom >= 1.0
    got, want = _both(_images(seed), params)
    np.testing.assert_allclose(got, want, atol=1e-4)


@pytest.mark.parametrize("params", FIXED)
def test_fixed_params(f32_geometry, params):
    got, want = _both(_images(4, (3, 20, 30, 3)), params)
    np.testing.assert_allclose(got, want, atol=1e-4)


@pytest.mark.parametrize("zoom,cx,cy", [(1.0, 0.5, 0.5), (1.03, 0.2, 0.9), (1.0540925, 1.0, 0.0)])
def test_crop_resize_matches_scale_and_translate(f32_geometry, zoom, cx, cy):
    """The likeliest divergence: JAX's linear scale_and_translate rebuilt as
    two 1-D weight matrices."""
    x = _images(5, (2, 24, 40, 3))
    want = jaug._crop_resize(jnp.asarray(x), jnp.float32(zoom), jnp.float32(cx), jnp.float32(cy))
    got = paug._crop_resize(torch.from_numpy(x), zoom, cx, cy)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_sampler_ranges():
    g = torch.Generator().manual_seed(0)
    for _ in range(50):
        p = paug.sample_augment_params(g)
        assert 0.6 <= p.brightness <= 1.4 and 0.8 <= p.saturation <= 1.2
        assert -0.05 <= p.hue <= 0.05 and 0.1 <= p.blur_sigma <= 2.0
        assert 1.0 <= p.crop_zoom <= 1.0 / np.sqrt(0.9) + 1e-6
        assert p.posterize_bits in (4.0, 5.0, 6.0, 7.0, 8.0) and p.sharpness in (1.0, 2.0)


def test_normalize_images_matches_jax():
    u8 = np.random.default_rng(6).integers(0, 256, (2, 5, 7, 3), dtype=np.uint8)
    want = np.asarray(jnorm.normalize_images(jnp.asarray(u8)))
    got = pnorm.normalize_images(torch.from_numpy(u8))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
