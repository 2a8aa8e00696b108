#!/usr/bin/env python3
"""Convert a JAX Orbax checkpoint of the JAX package into the PyTorch port's format.

    python3 tools/torch_from_orbax.py CKPT_DIR OUT_DIR [section.field=value ...]

CKPT_DIR is anything `safevla_tpu.utils.checkpoint.restore_policy_params`
reads: a trainer state, a bare params tree, or a run directory of `step_<n>`
children (the newest). The overrides set the model configuration the
checkpoint was trained with (the JAX package's `apply_overrides`; default
`Config()`). The policy weights (towers, and the frozen ViT and T5 when the
checkpoint carries them, else the JAX init's) are carried into a port policy
with `safevla_tpu_torch.models.from_jax.load_jax_params` and written as a
bare params tree, `OUT_DIR/step_<n>/params.pt` (n from CKPT_DIR's
`step_<n>`, else 0), which `InferenceAgent.build` and the port's evaluation
CLI read. Runs on the CPU. The port itself never reads Orbax: it imports
neither JAX nor the JAX package.
"""

from __future__ import annotations

import dataclasses
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)


def convert(ckpt_dir: str, out_dir: str, overrides=(), model_cfg=None, init_params=None) -> str:
    """Convert; returns the written `step_<n>` directory. `model_cfg` (a JAX
    `ModelConfig`) takes the place of the config overrides; `init_params`
    (the JAX policy's tree) of its init, which fills what the checkpoint
    does not carry."""
    import jax
    import torch

    from safevla_tpu.config import Config, apply_overrides
    from safevla_tpu.models.actor_critic import SafeVLAPolicy as JaxPolicy
    from safevla_tpu.utils.checkpoint import latest_checkpoint, restore_policy_params
    from safevla_tpu_torch.config import ModelConfig
    from safevla_tpu_torch.models.actor_critic import SafeVLAPolicy
    from safevla_tpu_torch.models.from_jax import load_jax_params
    from safevla_tpu_torch.utils.checkpoint import save_checkpoint

    mcfg = model_cfg or apply_overrides(Config(), list(overrides)).model
    if init_params is None:
        init_params = jax.jit(JaxPolicy(mcfg).init_params)(jax.random.PRNGKey(0))
    params = jax.device_get(restore_policy_params(ckpt_dir, init_params))
    policy = SafeVLAPolicy(ModelConfig(**dataclasses.asdict(mcfg)), device="cpu")
    load_jax_params(policy, params)
    name = os.path.basename(os.path.abspath(ckpt_dir))
    if not name.startswith("step_"):
        name = os.path.basename(latest_checkpoint(ckpt_dir) or "step_0")
    tree = {"towers": policy.towers.state_dict(), "vit": policy.vit.state_dict(),
            "t5": policy.t5.state_dict()}
    with torch.no_grad():
        return save_checkpoint(out_dir, tree, int(name.split("_", 1)[1]))


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) < 2 or argv[0] in ("-h", "--help"):
        print(__doc__)
        return 2
    import jax

    jax.config.update("jax_platforms", "cpu")
    print(convert(argv[0], argv[1], argv[2:]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
