"""Checkpoints in the port's own torch format, and policy restore from them.

Counterpart of `safevla_tpu/utils/checkpoint.py`, with the same directory
naming (`<path>/step_<n>/`); the JAX package writes Orbax directories, the
port one torch file in each:
  * `train_state.pt`, a trainer state (`save_checkpoint` of a TrainState):
    the tower weights (by their state-dict names), the frozen ViT and T5
    (`frozen_params`, so that a restored policy runs the backbone it was
    trained with), the Adam count and moments, the Lagrange state and the
    step. Files written before the frozen encoders were saved hold towers
    only, and restore with the encoders the policy was built with. The
    offline trainer's BCTrainState goes to the same file: the towers, the
    frozen encoders, the AdamW count and moments, the step and the epoch
    (`"kind": "bc"`, no Lagrange state);
  * `params.pt`, a bare params tree (`save_checkpoint` of a mapping):
    `{"towers": ..., "vit": ..., "t5": ...}`, each subtree optional, as
    `tools/torch_from_orbax.py` writes from a JAX Orbax checkpoint.
`restore_policy_params` reads either layout, or a run directory of
`step_<n>` children (the newest), into a policy; reference torch files go
through `models/convert.py`.
"""

from __future__ import annotations

import dataclasses
import os
import shutil
import tempfile
from typing import Mapping, Optional

import torch
from torch import nn

from safevla_tpu_torch.algo.lagrange import LagrangeState
from safevla_tpu_torch.algo.learner import TrainState
from safevla_tpu_torch.algo.optim import AdamState
from safevla_tpu_torch.parallel.distributed import is_primary_host

_FILE = "train_state.pt"
_PARAMS_FILE = "params.pt"


def _cpu(t: torch.Tensor) -> torch.Tensor:
    return t.detach().to("cpu", copy=True)


def _train_state_payload(train_state: TrainState) -> dict:
    opt, lag = train_state.opt_state, train_state.lagrange
    return {
        "step": int(train_state.step),
        "tower_params": {k: _cpu(p) for k, p in train_state.tower_params.items()},
        "frozen_params": {
            k: {n: _cpu(t) for n, t in sd.items()} for k, sd in train_state.frozen_params.items()
        },
        "adam": {"count": opt.count, "mu": [_cpu(m) for m in opt.mu], "nu": [_cpu(n) for n in opt.nu]},
        "lagrange": {
            "multiplier": _cpu(lag.multiplier),
            "count": lag.opt_state.count,
            "mu": [_cpu(m) for m in lag.opt_state.mu],
            "nu": [_cpu(n) for n in lag.opt_state.nu],
            "cost_limit": _cpu(lag.cost_limit),
            "upper_bound": lag.upper_bound,
        },
    }


def _bc_state_payload(state) -> dict:
    opt = state.opt_state
    return {
        "kind": "bc",
        "step": int(state.step),
        "epoch": int(state.epoch),
        "tower_params": {k: _cpu(p) for k, p in state.tower_params.items()},
        "frozen_params": {
            k: {n: _cpu(t) for n, t in sd.items()} for k, sd in state.frozen_params.items()
        },
        "adam": {"count": opt.count, "mu": [_cpu(m) for m in opt.mu], "nu": [_cpu(n) for n in opt.nu]},
    }


def _bc_state_type():
    # training/offline.py imports this module: its state type is looked up
    # at call time
    from safevla_tpu_torch.training.offline import BCTrainState

    return BCTrainState


def save_checkpoint(path: str, state, step: int) -> str:
    """Write `state` under `path/step_<step>`; returns that directory. A
    TrainState or a BCTrainState goes to `train_state.pt`, a params mapping
    (subtree name -> state dict) to `params.pt`. The directory appears whole
    or not at all (written aside, then renamed).

    On a multi-process run only rank 0 writes (the state is replicated;
    ranks racing on one directory would corrupt it): the others return the
    directory at once. SAFEVLA_SAVE_ON_ALL_HOSTS=1 makes every rank write,
    for hosts with private disks (the JAX package's switch)."""
    path = os.path.abspath(path)
    ckpt_dir = os.path.join(path, f"step_{step}")
    if not is_primary_host() and not os.environ.get("SAFEVLA_SAVE_ON_ALL_HOSTS"):
        return ckpt_dir
    os.makedirs(path, exist_ok=True)
    if isinstance(state, TrainState):
        name, payload = _FILE, _train_state_payload(state)
    elif isinstance(state, _bc_state_type()):
        name, payload = _FILE, _bc_state_payload(state)
    else:
        name = _PARAMS_FILE
        payload = {
            k: {n: _cpu(t) for n, t in v.items()} if isinstance(v, Mapping) else v
            for k, v in state.items()
        }
    tmp = tempfile.mkdtemp(prefix=f".step_{step}.", dir=path)
    torch.save(payload, os.path.join(tmp, name))
    if os.path.isdir(ckpt_dir):
        shutil.rmtree(ckpt_dir)
    os.replace(tmp, ckpt_dir)
    return ckpt_dir


def latest_checkpoint(path: str) -> Optional[str]:
    """The `step_<n>` directory of `path` with the largest n, or None."""
    path = os.path.abspath(path)
    if not os.path.isdir(path):
        return None
    steps = []
    for name in os.listdir(path):
        if name.startswith("step_"):
            try:
                steps.append((int(name.split("_", 1)[1]), name))
            except ValueError:
                continue
    if not steps:
        return None
    return os.path.join(path, max(steps)[1])


def _check_matches(saved: Mapping, live: Mapping, what: str) -> None:
    """Raise ValueError unless `saved` has exactly `live`'s names and shapes
    (e.g. a checkpoint of another backbone: a SigLIP or ResNet encoder has
    other names than a DINOv2 ViT, a ResNet's towers other widths)."""
    names = set(saved) ^ set(live)
    if names:
        raise ValueError(f"checkpoint {what} does not match the current model: names differ, e.g. {sorted(names)[:5]}")
    shapes = [n for n in live if tuple(saved[n].shape) != tuple(live[n].shape)]
    if shapes:
        n = shapes[0]
        raise ValueError(
            f"checkpoint {what} does not match the current model: {n} has shape "
            f"{tuple(saved[n].shape)}, the model {tuple(live[n].shape)}"
        )


@torch.no_grad()
def restore_checkpoint(ckpt_dir: str, target):
    """Load a trainer checkpoint into `target` (a TrainState over the live
    policy, e.g. `Learner.init()`, or a BCTrainState, e.g.
    `OfflineTrainer.init_state()`, of the checkpoint's own kind): the tower
    weights, the frozen encoders (when saved) and the Adam moments are
    copied in place, on their devices; returns the restored state."""
    file = os.path.join(os.path.abspath(ckpt_dir), _FILE)
    if not os.path.isfile(file):
        raise FileNotFoundError(f"{file}: not a trainer checkpoint of the port")
    payload = torch.load(file, map_location="cpu", weights_only=True)
    bc = isinstance(target, _bc_state_type())
    if bc != (payload.get("kind") == "bc"):
        raise ValueError(
            f"{file} holds a {'BC' if payload.get('kind') == 'bc' else 'PPO'} trainer state, "
            f"not a {type(target).__name__}"
        )
    params = target.tower_params
    frozen = payload.get("frozen_params", {})
    # every subtree checked before anything is copied
    _check_matches(payload["tower_params"], params, "tower parameters")
    for k, sd in frozen.items():
        _check_matches(sd, target.frozen_params[k], f"subtree {k!r}")
    for name, p in params.items():
        p.copy_(payload["tower_params"][name])
    for k, sd in frozen.items():
        for n, t in sd.items():
            target.frozen_params[k][n].copy_(t)
    adam = payload["adam"]
    for dst, src in zip(target.opt_state.mu + target.opt_state.nu, adam["mu"] + adam["nu"]):
        dst.copy_(src)
    opt_state = AdamState(adam["count"], target.opt_state.mu, target.opt_state.nu)
    if bc:
        return dataclasses.replace(target, opt_state=opt_state, step=payload["step"], epoch=payload["epoch"])
    lag = payload["lagrange"]
    dev = target.lagrange.multiplier.device
    to = lambda t: t.to(dev)
    lagrange = LagrangeState(
        multiplier=to(lag["multiplier"]),
        opt_state=AdamState(lag["count"], [to(m) for m in lag["mu"]], [to(n) for n in lag["nu"]]),
        cost_limit=to(lag["cost_limit"]),
        upper_bound=lag["upper_bound"],
    )
    return TrainState(
        tower_params=params,
        frozen_params=target.frozen_params,
        opt_state=opt_state,
        lagrange=lagrange,
        step=payload["step"],
    )


@torch.no_grad()
def restore_policy_params(ckpt_dir: str, policy: nn.Module) -> nn.Module:
    """Restore inference-ready policy weights from either of the port's
    layouts, in place; returns the policy.

    A trainer state (`tower_params`, `frozen_params`, ...) or a bare params
    tree (`towers`, optionally `vit` and `t5`); the subtrees the checkpoint
    carries replace the policy's, the rest keep the policy's init. The
    frozen ViT and T5 are taken from the checkpoint when present so
    evaluation runs the exact backbone training used. `ckpt_dir` may also be
    a run output directory of `step_<n>` children; the newest is used.
    """
    ckpt_dir = os.path.abspath(ckpt_dir)
    if not os.path.isdir(ckpt_dir):
        raise FileNotFoundError(ckpt_dir)
    if not os.path.basename(ckpt_dir).startswith("step_"):
        latest = latest_checkpoint(ckpt_dir)
        if latest is not None:
            ckpt_dir = latest
    files = [os.path.join(ckpt_dir, f) for f in (_FILE, _PARAMS_FILE)]
    found = [f for f in files if os.path.isfile(f)]
    if not found:
        raise FileNotFoundError(f"{ckpt_dir}: no {_FILE} or {_PARAMS_FILE}")
    raw = torch.load(found[0], map_location="cpu", weights_only=True)

    picked = {}
    if isinstance(raw, dict) and "tower_params" in raw:  # trainer state
        picked["towers"] = raw["tower_params"]
        for k, sd in (raw.get("frozen_params") or {}).items():
            picked[k] = sd
    elif isinstance(raw, dict) and "towers" in raw:  # bare params tree
        picked = {k: raw[k] for k in ("towers", "vit", "t5") if raw.get(k) is not None}
    else:
        keys = sorted(raw.keys()) if isinstance(raw, dict) else type(raw).__name__
        raise ValueError(
            f"{ckpt_dir} is not a recognized safevla checkpoint: expected a "
            f"trainer state ('tower_params') or a params tree ('towers'); "
            f"found {keys}. Torch-format reference files go through models/convert."
        )
    modules = {"towers": policy.towers, "vit": policy.vit, "t5": policy.t5}
    # every subtree checked before any is loaded (a checkpoint of another
    # backbone raises here, the policy untouched)
    for k, sd in picked.items():
        _check_matches(sd, modules[k].state_dict(), f"subtree {k!r}")
    for k, sd in picked.items():
        modules[k].load_state_dict(sd)
    return policy


def resolve_checkpoint_path(path: str) -> str:
    """Resolve a checkpoint reference to a local path. Local paths pass
    through. A `wandb://entity/project/artifact:alias` reference raises: the
    JAX package fetches it over the network with the wandb package; the port
    takes a local copy only."""
    if not path.startswith("wandb://"):
        return path
    try:
        import wandb  # noqa: F401
    except ImportError as e:
        raise RuntimeError(
            f"checkpoint {path!r} is a wandb artifact but the wandb package "
            "is not installed; download it manually or install wandb"
        ) from e
    raise NotImplementedError(
        f"checkpoint {path!r} is a wandb artifact: the port does not fetch "
        "artifacts; download it and pass the local path"
    )
