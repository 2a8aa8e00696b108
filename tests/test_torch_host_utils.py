"""The port's small host utilities against the JAX package's: `utils/nn_info.py`
(parameter counts of a policy whose weights `load_jax_params` carried over,
per top-level subtree, from the module and from its state dict),
`utils/synsets.py` (its path without WordNet), `utils/debug.py` and the
constants the AI2-THOR controller reads."""

import numpy as np

import torch_port_tiny as tiny
from safevla_tpu import constants as jconst
from safevla_tpu.models import actor_critic as jac
from safevla_tpu.utils import debug as jdebug
from safevla_tpu.utils import nn_info as jnn
from safevla_tpu.utils import synsets as jsyn
from safevla_tpu_torch import constants as pconst
from safevla_tpu_torch.utils import debug as pdebug
from safevla_tpu_torch.utils import nn_info as pnn
from safevla_tpu_torch.utils import synsets as psyn


def test_nn_info_counts_equal_jax(tiny_model_cfg, monkeypatch):
    tiny.register_tiny_vit(monkeypatch)
    mcfg = tiny.model_cfg(tiny_model_cfg)
    params = tiny.random_params(jac.SafeVLAPolicy(mcfg), seed=1)
    policy = tiny.port_policy(mcfg, params)
    want = jnn.param_breakdown(params)
    assert set(want) == {"vit", "t5", "towers"}
    assert pnn.param_breakdown(policy) == want
    assert pnn.param_breakdown(policy.state_dict()) == want
    assert pnn.param_count(policy) == jnn.param_count(params) == sum(want.values())
    lines_p, lines_j = [], []
    assert pnn.debug_model_info(policy, lines_p.append) == jnn.debug_model_info(params, lines_j.append)
    assert lines_p == lines_j and lines_p[-1].split()[0] == "total"
    assert pnn.param_count({"a": np.zeros((3, 4)), "b": [np.zeros(5)]}) == 17


def test_synsets_match_jax(monkeypatch):
    """The string-level path (no WordNet corpus: a synset is its own only
    hypernym), forced on both sides so the test does not hang on the data."""
    for mod in (psyn, jsyn):
        monkeypatch.setattr(mod, "_wn", lambda: None)
        mod.all_hypernyms.cache_clear()
        mod.is_hypernym_of.cache_clear()
    table = {"mug.n.01": ["Mug|1"], "cup.n.01": ["Cup|2"], "apple.n.01": ["Apple|3"]}
    for s in ("mug.n.01", "cup.n.01", "apple.n.01"):
        assert psyn.all_hypernyms(s) == jsyn.all_hypernyms(s) == {s}
        assert psyn.all_hypernyms(s, include_self=False) == jsyn.all_hypernyms(s, include_self=False)
        assert psyn.broad_object_ids(table, s) == jsyn.broad_object_ids(table, s) == table[s]
        assert psyn.is_hypernym_of(s, "cup.n.01") == jsyn.is_hypernym_of(s, "cup.n.01")
    for mod in (psyn, jsyn):
        mod.all_hypernyms.cache_clear()
        mod.is_hypernym_of.cache_clear()


def test_debug_and_thor_constants_match_jax():
    assert pdebug.ForkedPdb is pdebug.WorkerPdb and issubclass(pdebug.WorkerPdb, jdebug.pdb.Pdb)
    names = ("ARM_MOVE_CONSTANT", "WRIST_ROTATION", "EMPTY_BBOX", "EMPTY_DOUBLE_BBOX", "INTEL_VERTICAL_FOV",
             "MAXIMUM_SERVER_TIMEOUT", "STRETCH_WRIST_BOUND_1", "STRETCH_WRIST_BOUND_2", "STRETCH_COMMIT_ID",
             "ADDITIONAL_ARM_ARGS", "ADDITIONAL_NAVIGATION_ARGS", "INTEL_CAMERA_WIDTH", "INTEL_CAMERA_HEIGHT")
    for name in names:
        assert getattr(pconst, name) == getattr(jconst, name), name
