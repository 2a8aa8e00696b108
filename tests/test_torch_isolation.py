"""The port stands alone: it imports neither JAX nor the JAX package, its
entry points refuse a missing CUDA unless asked for the CPU, and
chip_smoke.py imports nothing of the JAX package."""

import ast
import pathlib
import subprocess
import sys

import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parent.parent
PKG = REPO / "safevla_tpu_torch"


def _port_modules():
    for path in sorted(PKG.rglob("*.py")):
        rel = path.relative_to(REPO).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        yield ".".join(parts)


def test_importing_the_port_loads_no_jax():
    mods = list(_port_modules())
    assert "safevla_tpu_torch.ops.flash_attention" in mods
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'safevla_tpu'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=300
    )
    assert out.returncode == 0, out.stdout + out.stderr


def _imported_names(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


@pytest.mark.parametrize(
    "path",
    [REPO / "chip_smoke.py", *sorted(PKG.rglob("*.py"))],
    ids=lambda p: str(p.relative_to(REPO)),
)
def test_sources_import_nothing_of_jax(path):
    roots = {name.split(".")[0] for name in _imported_names(path)}
    assert not roots & {"jax", "jaxlib", "flax", "optax", "safevla_tpu"}, roots


def test_entry_points_refuse_missing_cuda(monkeypatch):
    from safevla_tpu_torch.config import Config
    from safevla_tpu_torch.evaluation.agent import InferenceAgent
    from safevla_tpu_torch.models.actor_critic import SafeVLAPolicy

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        InferenceAgent.build(Config(), None, num_streams=2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        SafeVLAPolicy(Config().model)


def test_checkpoint_restore_is_not_ported_yet():
    from safevla_tpu_torch.config import Config
    from safevla_tpu_torch.evaluation.agent import InferenceAgent

    with pytest.raises(NotImplementedError):
        InferenceAgent.build(Config(), "some/checkpoint", num_streams=2, device="cpu")
