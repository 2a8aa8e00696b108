"""PyTorch / CUDA port of safevla_tpu for one NVIDIA H100.

The JAX package `safevla_tpu` is the reference; this package mirrors its
layout and names module for module. It imports torch and numpy only —
nothing of JAX and nothing of `safevla_tpu` — and keeps its own copies of
the pure-Python pieces it needs (config, constants, tokenizer).

Ported so far: the serving path, `evaluation.agent.InferenceAgent.act`
(augment -> normalise -> DINOv2 ViT -> 3 policy towers -> action), with the
packed-qkv flash-attention forward as a hand-written CUDA kernel
(`csrc/flash_attention_fwd.cu`, built at first use by `ops/_build.py`).

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
