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
    assert {f"safevla_tpu_torch.models.{m}" for m in ("text_towers", "resnet", "visual_encoders")} <= set(mods)
    assert {f"safevla_tpu_torch.parallel.{m}" for m in ("mesh", "distributed")} <= set(mods)
    assert {f"safevla_tpu_torch.envs.{m}" for m in ("thor_controller", "replay_controller", "detic")} <= set(mods)
    assert "safevla_tpu_torch.native.obs_ring" in mods
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
    """Restore is ported now (tests/test_torch_evaluation.py): a checkpoint
    that is not there raises, and a wandb artifact is never fetched (the
    port reads local paths only; without the wandb package it raises the JAX
    package's RuntimeError)."""
    from safevla_tpu_torch.config import Config
    from safevla_tpu_torch.evaluation.agent import InferenceAgent
    from safevla_tpu_torch.utils.checkpoint import resolve_checkpoint_path

    with pytest.raises(FileNotFoundError):
        InferenceAgent.build(Config(), "some/checkpoint", num_streams=2, device="cpu")
    assert resolve_checkpoint_path("some/dir") == "some/dir"
    with pytest.raises((RuntimeError, NotImplementedError), match="wandb artifact"):
        resolve_checkpoint_path("wandb://entity/project/run:latest")


def test_trainer_refuses_missing_cuda(monkeypatch):
    from safevla_tpu_torch.config import Config
    from safevla_tpu_torch.envs.fake_tasks import make_sampler_factory
    from safevla_tpu_torch.training.online import OnlineTrainer

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        OnlineTrainer(Config(), make_sampler_factory(), num_workers=0, async_pipeline=False)


def test_the_port_has_a_module_for_each_of_jax_but_three():
    """Every module path of the JAX package has one in the port, but TPU
    detection, XLA's compile cache and an XLA lowering choice, which eager
    PyTorch has no use for."""
    jax_pkg = REPO / "safevla_tpu"
    jax_only = {
        str(p.relative_to(jax_pkg)) for p in jax_pkg.rglob("*.py") if not (PKG / p.relative_to(jax_pkg)).exists()
    }
    assert jax_only == {"utils/platform.py", "utils/jax_cache.py", "models/scan_policy.py"}
