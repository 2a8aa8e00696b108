"""Shared set-up of the port's training-slice tests: one tiny f32 policy on
both sides (JAX package and port, the same weights carried by
`load_jax_params`) and a packed rollout batch made with numpy from a seed.

The config is `tests/conftest.py::tiny_model_cfg` with three fusion layers
(layers 0-1 take the packed attention path) and `fusion_chunk` 8 < B*T = 24,
so the update's chunking and checkpointing run."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from safevla_tpu.models import vit as jvit
from safevla_tpu_torch.config import ModelConfig
from safevla_tpu_torch.models import actor_critic as pac
from safevla_tpu_torch.models import vit as pvit
from safevla_tpu_torch.models.from_jax import load_jax_params

VIT = "torch_port_tiny_f32"
VIT_KW = dict(embed_dim=32, depth=1, num_heads=2, img_height=28, img_width=42, patch_size=14)
B, T, L, E = 3, 8, 8, 2  # streams, steps, text tokens, episodes in the text table


def one_torch_thread():
    """Generator for a module-scoped fixture: torch's CPU ops on one thread
    while the module runs. At these sizes more threads gain nothing, and
    next to other test processes (pytest-xdist) each extra thread only
    contends for the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def register_tiny_vit(monkeypatch):
    monkeypatch.setitem(jvit.VIT_CONFIGS, VIT, jvit.DinoViTConfig(dtype=jnp.float32, **VIT_KW))
    monkeypatch.setitem(pvit.VIT_CONFIGS, VIT, pvit.DinoViTConfig(dtype=torch.float32, **VIT_KW))


def model_cfg(tiny_model_cfg):
    return dataclasses.replace(
        tiny_model_cfg, vision_backbone=VIT, combiner_layers=3, fusion_chunk=8
    )


def random_params(jpol, seed, scale=0.05):
    """Numpy weights for every leaf of the JAX policy's parameter tree, made
    from a seed without compiling its init (only the tree's shapes are
    traced): dense kernels N(0, 1/fan_in), norm and layer scales 1 + noise,
    every other leaf (biases, embeddings, tokens) noise, the noise N(0,
    scale^2). So no weight sits at an init constant (zero biases, unit norms)."""
    shapes = jax.eval_shape(jpol.init_params, jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = str(path[-1].key)
        x = rng.standard_normal(s.shape).astype(np.float32)
        if name == "kernel":  # (..., in, out)
            return x / np.float32(np.sqrt(s.shape[-2]))
        if name == "in_proj_weight":  # (..., 3 * dim, dim)
            return x / np.float32(np.sqrt(s.shape[-1]))
        if name == "patch_embed_kernel":  # (ph, pw, 3, out)
            return x / np.float32(np.sqrt(np.prod(s.shape[:-1])))
        if name in ("scale", "weight") or name.endswith("gamma"):
            return np.float32(1.0) + np.float32(scale) * x
        return np.float32(scale) * x

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def port_policy(mcfg, params_np):
    policy = pac.SafeVLAPolicy(ModelConfig(**dataclasses.asdict(mcfg)), device="cpu")
    return load_jax_params(policy, params_np)


def rollout_batch(mcfg, seed=0, text_layout="table", b=B):
    """A (b, T) window with episode boundaries (stream 0 restarts at t=5,
    stream 2 at t=3): traj_idx, not_reset, masks and time_step agree."""
    B = b
    rng = np.random.default_rng(seed)
    f = lambda *shape: rng.normal(size=shape).astype(np.float32)
    gh, gw = mcfg.vision_grid
    not_reset = np.ones((B, T), np.int32)
    not_reset[:, 0] = 0
    not_reset[0, 5] = 0
    not_reset[2, 3] = 0
    traj = np.cumsum(1 - not_reset, axis=1).astype(np.int32) - 1
    time_step = np.zeros((B, T), np.int32)
    for t in range(1, T):
        time_step[:, t] = np.where(not_reset[:, t] == 0, 0, time_step[:, t - 1] + 1)
    masks = np.ones((B, T + 1), np.float32)
    masks[:, :T] = not_reset
    batch = {
        "dino_nav": f(B, T, gh, gw, mcfg.vision_feature_dim),
        "dino_manip": f(B, T, gh, gw, mcfg.vision_feature_dim),
        "prev_actions": rng.integers(0, mcfg.num_actions, (B, T)).astype(np.int32),
        "not_reset": not_reset,
        "object_in_hand": rng.integers(0, 3, (B, T)).astype(np.int32),
        "time_step": time_step,
        "traj_idx": traj,
        "actions": rng.integers(0, mcfg.num_actions, (B, T)).astype(np.int32),
        "old_log_probs": (-3.0 + 0.1 * f(B, T)).astype(np.float32),
        "rewards": f(B, T),
        "costs": rng.integers(0, 3, (B, T)).astype(np.float32),
        "values": f(B, T + 1),
        "c_values": f(B, T + 1),
        "masks": masks,
    }
    # right-padded instructions of different lengths
    if text_layout == "table":  # (B, E, L, D) indexed by each step's episode
        shape, lead = (B, E), (B, E)
        batch["text_idx"] = np.minimum(traj, E - 1).astype(np.int32)
    elif text_layout == "per_step":  # (B, T, L, D)
        shape, lead = (B, T), (B, T)
    else:  # "per_stream": (B, L, D), one instruction per stream
        shape, lead = (B,), (B,)
    batch["text_hidden"] = f(*shape, L, mcfg.text_embed_size)
    lens = rng.integers(1, L + 1, lead)
    batch["text_mask"] = np.arange(L) < lens[..., None]
    return batch
