"""The port stands alone: it imports neither JAX nor the JAX package, its
entry points refuse a missing CUDA unless asked for the CPU, and
chip_smoke.py and tools/torch_exp_attn_bwd.py import nothing of the JAX
package. Every public name of a JAX module has a counterpart at the same
path in the port, or is listed below with the reason it has none."""

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
    [REPO / "chip_smoke.py", REPO / "tools" / "torch_exp_attn_bwd.py", *sorted(PKG.rglob("*.py"))],
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


def test_the_exp_attn_bwd_tool_loads_no_jax():
    code = (
        "import importlib.util, sys\n"
        "spec = importlib.util.spec_from_file_location('t', 'tools/torch_exp_attn_bwd.py')\n"
        "spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'safevla_tpu'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr


# JAX public names whose counterpart in the same port module has another name
RENAMED = {
    "models/vit.py::ViTAttention": "Attention",  # timm's module names, which the state dicts carry
    "models/vit.py::ViTBlock": "Block",
    "ops/flash_attention.py::flash_attention_qkv": "attention_qkv",  # the kernel entry, its VJP attached
}
_FLAX_SETUP = "Flax's deferred submodule setup: a torch module builds its submodules in __init__"
# JAX public names with no counterpart in the port, each with its reason
NO_COUNTERPART = {
    "models/actor_critic.py::PolicyTower.setup": _FLAX_SETUP,
    "models/llama_decoder.py::Attention.setup": _FLAX_SETUP,
    "models/llama_decoder.py::DecoderBlock.setup": _FLAX_SETUP,
    "models/llama_decoder.py::LlamaDecoder.setup": _FLAX_SETUP,
    "models/actor_critic.py::PolicyState.tree_flatten":
        "JAX pytree registration; the port's PolicyState is a dataclass of tensors, carried as is",
    "models/actor_critic.py::PolicyState.tree_unflatten":
        "JAX pytree registration; the port's PolicyState is a dataclass of tensors, carried as is",
    "algo/learner.py::Learner.split_update_fns":
        "builds the split update's jitted XLA programs; the port runs Learner.update eagerly",
    "algo/learner.py::Learner.chunked_update_fns":
        "builds the chunked update's jitted XLA programs; the port runs chunked_update / "
        "iter_chunked_update eagerly",
    "models/convert.py::import_tower_state_dict":
        "maps a reference tower's state dict onto a Flax tree; the port's towers carry the reference "
        "names and load it directly (load_reference_towers)",
    "models/convert.py::import_stacked_towers_from_torch":
        "stacks the Flax towers of a reference checkpoint; the port reads it with "
        "read_reference_checkpoint / load_reference_checkpoint",
}


def _public_names(path):
    """Public top-level functions, classes and assigned names of a module
    (in its `if` / `try` blocks too), and `Class.method` for the public
    methods of its public classes."""
    names = set()

    def walk(body):
        for node in body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
                if node.name.startswith("_"):
                    continue
                names.add(node.name)
                if isinstance(node, ast.ClassDef):
                    names.update(f"{node.name}.{m.name}" for m in node.body
                                 if isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef))
                                 and not m.name.startswith("_"))
            elif isinstance(node, (ast.Assign, ast.AnnAssign)):
                for target in node.targets if isinstance(node, ast.Assign) else [node.target]:
                    names.update(n.id for n in ast.walk(target)
                                 if isinstance(n, ast.Name) and not n.id.startswith("_"))
            elif isinstance(node, (ast.Import, ast.ImportFrom)):
                names.update((a.asname or a.name).split(".")[0] for a in node.names)
            elif isinstance(node, ast.If):
                walk(node.body)
                walk(node.orelse)
            elif isinstance(node, ast.Try):
                walk(node.body)
                for handler in node.handlers:
                    walk(handler.body)

    walk(ast.parse(path.read_text()).body)
    return names


def _jax_modules():
    jax_pkg = REPO / "safevla_tpu"
    for path in sorted(jax_pkg.rglob("*.py")):
        rel = str(path.relative_to(jax_pkg))
        if (PKG / rel).exists():
            yield rel, path


def test_every_public_name_of_jax_has_a_counterpart_or_a_reason():
    """An ast walk of each JAX module and its port module: a public name of
    the JAX module (its imports aside) is defined, imported or assigned in
    the port module, or renamed there (RENAMED, the new name present), or
    listed in NO_COUNTERPART with its reason; and every listed name is one
    the port lacks."""
    missing, listed = [], set()
    for rel, path in _jax_modules():
        tree = ast.parse(path.read_text())
        imported = {(a.asname or a.name).split(".")[0] for n in ast.walk(tree)
                    if isinstance(n, (ast.Import, ast.ImportFrom)) for a in n.names}
        port = _public_names(PKG / rel)
        for name in sorted(_public_names(path) - imported):
            key = f"{rel}::{name}"
            if name in port:
                continue
            listed.add(key)
            if key in RENAMED:
                assert RENAMED[key] in port, (key, RENAMED[key])
            elif key not in NO_COUNTERPART:
                missing.append(key)
    assert not missing, missing
    assert listed == set(RENAMED) | set(NO_COUNTERPART)
    assert all(reason.strip() for reason in NO_COUNTERPART.values())
