"""Checkpoints of the online trainer, in the port's own torch format.

Counterpart of `safevla_tpu/utils/checkpoint.py::save_checkpoint`,
`latest_checkpoint` and `restore_checkpoint`, with the same directory naming
(`<path>/step_<n>/`); the JAX package writes Orbax directories, the port one
`train_state.pt` file in each, holding the tower weights (by their state-dict
names), the Adam count and moments, the Lagrange state and the step. The
frozen ViT and T5 are not stored: they do not train. Orbax directories and
reference torch checkpoints are not read yet.
"""

from __future__ import annotations

import os
import shutil
import tempfile
from typing import Optional

import torch

from safevla_tpu_torch.algo.lagrange import LagrangeState
from safevla_tpu_torch.algo.learner import TrainState
from safevla_tpu_torch.algo.optim import AdamState

_FILE = "train_state.pt"


def save_checkpoint(path: str, train_state: TrainState, step: int) -> str:
    """Write `train_state` under `path/step_<step>`; returns that directory.
    The directory appears whole or not at all (written aside, then renamed)."""
    path = os.path.abspath(path)
    ckpt_dir = os.path.join(path, f"step_{step}")
    os.makedirs(path, exist_ok=True)
    cpu = lambda t: t.detach().to("cpu", copy=True)
    opt, lag = train_state.opt_state, train_state.lagrange
    payload = {
        "step": int(train_state.step),
        "tower_params": {k: cpu(p) for k, p in train_state.tower_params.items()},
        "adam": {"count": opt.count, "mu": [cpu(m) for m in opt.mu], "nu": [cpu(n) for n in opt.nu]},
        "lagrange": {
            "multiplier": cpu(lag.multiplier),
            "count": lag.opt_state.count,
            "mu": [cpu(m) for m in lag.opt_state.mu],
            "nu": [cpu(n) for n in lag.opt_state.nu],
            "cost_limit": cpu(lag.cost_limit),
            "upper_bound": lag.upper_bound,
        },
    }
    tmp = tempfile.mkdtemp(prefix=f".step_{step}.", dir=path)
    torch.save(payload, os.path.join(tmp, _FILE))
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


@torch.no_grad()
def restore_checkpoint(ckpt_dir: str, target: TrainState) -> TrainState:
    """Load a checkpoint into `target` (a TrainState over the live policy,
    e.g. `Learner.init()`): the tower weights and the Adam moments are
    copied in place, on their devices; returns the restored TrainState."""
    file = os.path.join(os.path.abspath(ckpt_dir), _FILE)
    if not os.path.isfile(file):
        raise FileNotFoundError(f"{file}: not a checkpoint of the port (Orbax and reference files are not read yet)")
    payload = torch.load(file, map_location="cpu", weights_only=True)
    params = target.tower_params
    if set(payload["tower_params"]) != set(params):
        missing = sorted(set(params) ^ set(payload["tower_params"]))[:5]
        raise ValueError(f"checkpoint tower parameters differ from the model's, e.g. {missing}")
    for name, p in params.items():
        p.copy_(payload["tower_params"][name])
    adam = payload["adam"]
    for dst, src in zip(target.opt_state.mu + target.opt_state.nu, adam["mu"] + adam["nu"]):
        dst.copy_(src)
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
        opt_state=AdamState(adam["count"], target.opt_state.mu, target.opt_state.nu),
        lagrange=lagrange,
        step=payload["step"],
    )
