"""Model introspection (reference utils/nn_utils.py: debug_model_info).

The port's counterpart of `safevla_tpu/utils/nn_info.py`, over an
`nn.Module` (its parameters) or a state dict (every tensor in it, keyed by
dotted names or nested mappings) where the JAX copy takes a pytree.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, Mapping

import numpy as np
from torch import nn


def _leaves(tree: Any) -> Iterator[Any]:
    if isinstance(tree, nn.Module):
        yield from tree.parameters()
    elif isinstance(tree, Mapping):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def param_count(tree: Any) -> int:
    return int(sum(np.prod(x.shape) for x in _leaves(tree)))


def param_breakdown(params: Any) -> Dict[str, int]:
    """Top-level subtree parameter counts: a module's children (and its own
    parameters), or a state dict's first name component."""
    if isinstance(params, nn.Module):
        out = {k: param_count(v) for k, v in params.named_children()}
        out.update({k: param_count(v) for k, v in params.named_parameters(recurse=False)})
        return {k: v for k, v in out.items() if v}
    out: Dict[str, int] = {}
    for k, v in params.items():
        top = k.split(".", 1)[0]
        out[top] = out.get(top, 0) + param_count(v)
    return out


def debug_model_info(params: Any, print_fn=print) -> Dict[str, int]:
    info = param_breakdown(params)
    total = sum(info.values())
    for k, v in sorted(info.items()):
        print_fn(f"  {k:24s} {v / 1e6:8.2f}M params")
    print_fn(f"  {'total':24s} {total / 1e6:8.2f}M params")
    return info
