"""PyTorch / CUDA port of safevla_tpu for one NVIDIA H100.

The JAX package `safevla_tpu` is the reference; this package mirrors its
layout and names module for module. It imports torch and numpy only —
nothing of JAX and nothing of `safevla_tpu` — and keeps its own copies of
the pure-Python pieces it needs (config, constants, tokenizer, the host
environment stack).

Ported so far: the serving path, `evaluation.agent.InferenceAgent.act`
(augment -> normalise -> DINOv2 ViT -> 3 policy towers -> action); the
learner update, `algo.learner.Learner.update` (GAE -> Lagrange ascent ->
PPO epochs over `SafeVLAPolicy.forward_seq` -> optax's clip + Adam); the
online trainer, `training.online.OnlineTrainer.train` (`rollout.env_pool`
-> `rollout.runner.RolloutRunner.collect` -> the update, with checkpoints),
sync and in the default async pipeline (the update as chunk programs,
`Learner.iter_chunked_update`, on a CUDA stream of its own while the next
window is collected), on a copy of the FakeController / ObjectNav
environment stack (`envs`, `tasks`); evaluation with checkpoint restore
(`evaluation.evaluator.BatchedEvaluator`, `cli.evaluate`); offline
behaviour cloning (`training.offline.OfflineTrainer.fit`, `cli.train_offline`);
and online training from its command line (`cli.train_online`, with the
sampler factories of `launch`) on every task family of the JAX package
(`tasks`) with the linear, mlp and HL-Gauss discrete critics; and
data-parallel training over torch.distributed ranks, one process per GPU
(`parallel`: the `("dp", "mdl")` mesh, `MeshConfig`, the `mesh=` branches
of the learner, runner, trainers and `cli.train_online`). The packed-qkv
flash-attention forward and backward and the row
LayerNorm forward and backward are hand-written CUDA kernels (`csrc/{flash_attention_fwd,flash_attention_bwd,
layer_norm}.cu`, built at first use by `ops/_build.py`).

Entry points default to `device="cuda"` and raise when CUDA is absent unless
the caller asks for `device="cpu"`; on the CPU every kernel wrapper runs its
plain PyTorch version.
"""

import torch


def resolve_device(device) -> torch.device:
    """torch.device for an entry point; refuses "cuda" on a machine without it
    (the CPU is only taken when the caller asks for it)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available on this machine; pass device='cpu' to run "
            "the port's plain PyTorch path on the CPU"
        )
    return device
