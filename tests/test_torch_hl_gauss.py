"""The port's HL-Gauss transform (`safevla_tpu_torch/ops/hl_gauss.py`)
against the JAX package's (`safevla_tpu/ops/hl_gauss.py`) in f32, on seeded
targets that include some outside [min, max] and on seeded logits, at the
default bins and at a small custom support."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from safevla_tpu.ops.hl_gauss import HLGauss as JaxHLGauss
from safevla_tpu_torch.ops.hl_gauss import HLGauss

TOL = 1e-6
SUPPORTS = {
    "default": dict(min_value=-5.0, max_value=15.0, num_bins=101, sigma=0.15),
    "small": dict(min_value=-1.0, max_value=2.0, num_bins=7, sigma=0.5),
}


def _inputs(kw, seed):
    rng = np.random.default_rng(seed)
    span = kw["max_value"] - kw["min_value"]
    # a fifth of the targets beyond either end of the support
    targets = rng.uniform(kw["min_value"] - 0.1 * span, kw["max_value"] + 0.1 * span, (4, 5))
    logits = rng.normal(size=(4, 5, kw["num_bins"])) * 3.0
    return targets.astype(np.float32), logits.astype(np.float32)


@pytest.mark.parametrize("support", sorted(SUPPORTS))
@pytest.mark.parametrize("fn", ["to_probs", "from_logits", "loss", "from_probs"])
def test_hl_gauss_matches_jax(support, fn):
    kw = SUPPORTS[support]
    targets, logits = _inputs(kw, seed=len(fn) + kw["num_bins"])
    j, p = JaxHLGauss(**kw), HLGauss(**kw)
    if fn == "to_probs":
        want, got = j.to_probs(jnp.asarray(targets)), p.to_probs(torch.from_numpy(targets))
    elif fn == "from_logits":
        want, got = j.from_logits(jnp.asarray(logits)), p.from_logits(torch.from_numpy(logits))
    elif fn == "from_probs":
        probs = np.array(j.to_probs(jnp.asarray(targets)))
        want, got = j.from_probs(jnp.asarray(probs)), p.from_probs(torch.from_numpy(probs))
    else:
        want = j.loss(jnp.asarray(logits), jnp.asarray(targets))
        got = p.loss(torch.from_numpy(logits), torch.from_numpy(targets))
    assert got.dtype == torch.float32 and tuple(got.shape) == tuple(np.shape(want))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=TOL)


def test_hl_gauss_round_trip_inside_support():
    """A target well inside the support reads back from its own histogram."""
    hl = HLGauss()
    t = torch.tensor([-3.0, 0.0, 2.5, 11.0])
    torch.testing.assert_close(hl.from_probs(hl.to_probs(t)), t, rtol=0, atol=1e-4)
