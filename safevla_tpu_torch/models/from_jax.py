"""Carry weights from the JAX package's parameter tree into the port.

`load_jax_params(policy, params_np)` takes the JAX `SafeVLAPolicy` tree
`{"vit", "t5", "towers"}` as numpy arrays (e.g. `jax.device_get(params)`)
and fills the port's modules:
  * flax Dense kernels (in, out) -> torch Linear weights (out, in);
  * the ViT patch kernel (P, P, 3, D) -> the hub's conv weight (D, 3, P, P);
    the compressors' Dense kernels -> 1x1 conv weights (out, in, 1, 1);
  * depth-stacked scan leaves (ViT `blocks`, fusion `layers` + `layer_last`,
    decoder `layers`) -> one module per layer;
  * tower-stacked leaves (leading axis = tower) -> the three towers;
  * flax LayerNorm scale / bias -> weight / bias.
The port's names are the reference's torch names, so the JAX package's own
importers (`safevla_tpu/models/convert.py`) read a port state dict back.
Values are cast to each parameter's dtype on load (bf16 Linear weights get
the same rounding the JAX modules apply at every use).
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from safevla_tpu_torch.models.actor_critic import SafeVLAPolicy


def _params(tree: Mapping) -> Mapping:
    return tree["params"] if "params" in tree else tree


def _dense(prefix: str, leaf: Mapping, bias: bool = True) -> Dict[str, np.ndarray]:
    out = {f"{prefix}.weight": np.asarray(leaf["kernel"]).T}
    if bias and "bias" in leaf:
        out[f"{prefix}.bias"] = np.asarray(leaf["bias"])
    return out


def _ln(prefix: str, leaf: Mapping) -> Dict[str, np.ndarray]:
    return {f"{prefix}.weight": np.asarray(leaf["scale"]), f"{prefix}.bias": np.asarray(leaf["bias"])}


def _unstack(tree: Any, i: int) -> Any:
    """Layer i of a depth-stacked (or tower i of a tower-stacked) tree."""
    if isinstance(tree, Mapping):
        return {k: _unstack(v, i) for k, v in tree.items()}
    return np.asarray(tree)[i]


def vit_state_dict(p: Mapping) -> Dict[str, np.ndarray]:
    p = _params(p)
    sd = {
        "patch_embed.proj.weight": np.asarray(p["patch_embed_kernel"]).transpose(3, 2, 0, 1),
        "patch_embed.proj.bias": np.asarray(p["patch_embed_bias"]),
        "pos_embed": np.asarray(p["pos_embed"]),
        **_ln("norm", p["norm"]),
    }
    if "cls_token" in p:
        sd["cls_token"] = np.asarray(p["cls_token"])
    depth = np.asarray(p["blocks"]["norm1"]["scale"]).shape[0]
    for i in range(depth):
        b, pre = _unstack(p["blocks"], i), f"blocks.{i}"
        sd.update(_ln(f"{pre}.norm1", b["norm1"]))
        sd.update(_ln(f"{pre}.norm2", b["norm2"]))
        sd.update(_dense(f"{pre}.attn.qkv", b["attn"]["qkv"]))
        sd.update(_dense(f"{pre}.attn.proj", b["attn"]["proj"]))
        sd.update(_dense(f"{pre}.mlp.fc1", b["mlp_fc1"]))
        sd.update(_dense(f"{pre}.mlp.fc2", b["mlp_fc2"]))
        if "ls1_gamma" in b:
            sd[f"{pre}.ls1.gamma"] = b["ls1_gamma"]
            sd[f"{pre}.ls2.gamma"] = b["ls2_gamma"]
    return sd


def t5_state_dict(p: Mapping) -> Dict[str, np.ndarray]:
    p = _params(p)
    sd = {
        "shared.weight": np.asarray(p["token_embed"]),
        "encoder.final_layer_norm.weight": np.asarray(p["final_norm"]["weight"]),
    }
    i = 0
    while f"block_{i}" in p:
        b, pre = p[f"block_{i}"], f"encoder.block.{i}.layer"
        sd[f"{pre}.0.layer_norm.weight"] = np.asarray(b["attn_norm"]["weight"])
        for name in ("q", "k", "v", "o"):
            sd.update(_dense(f"{pre}.0.SelfAttention.{name}", b["attn"][name], bias=False))
        if "relative_attention_bias" in b["attn"]:
            sd[f"{pre}.0.SelfAttention.relative_attention_bias.weight"] = np.asarray(
                b["attn"]["relative_attention_bias"]
            )
        sd[f"{pre}.1.layer_norm.weight"] = np.asarray(b["ffn_norm"]["weight"])
        sd.update(_dense(f"{pre}.1.DenseReluDense.wi", b["wi"], bias=False))
        sd.update(_dense(f"{pre}.1.DenseReluDense.wo", b["wo"], bias=False))
        i += 1
    return sd


def _fusion_layer(pre: str, f: Mapping) -> Dict[str, np.ndarray]:
    sa = f["self_attn"]
    return {
        f"{pre}.self_attn.in_proj_weight": np.asarray(sa["in_proj_weight"]),
        f"{pre}.self_attn.in_proj_bias": np.asarray(sa["in_proj_bias"]),
        **_dense(f"{pre}.self_attn.out_proj", sa["out_proj"]),
        **_dense(f"{pre}.linear1", f["linear1"]),
        **_dense(f"{pre}.linear2", f["linear2"]),
        **_ln(f"{pre}.norm1", f["norm1"]),
        **_ln(f"{pre}.norm2", f["norm2"]),
    }


def tower_state_dict(p: Mapping) -> Dict[str, np.ndarray]:
    """One (unstacked) flax PolicyTower tree -> reference-named torch keys."""
    p = _params(p)
    ve = "visual_encoder"
    sd: Dict[str, np.ndarray] = {}
    for i, name in ((0, "compressor0"), (2, "compressor1")):
        k = np.asarray(p[name]["kernel"]).T
        sd[f"{ve}.visual_compressor.{i}.weight"] = k[:, :, None, None]
        sd[f"{ve}.visual_compressor.{i}.bias"] = np.asarray(p[name]["bias"])
    sd.update(_dense(f"{ve}.visual_adapter.0", p["visual_adapter_fc"]))
    sd.update(_ln(f"{ve}.visual_adapter.1", p["visual_adapter_ln"]))
    sd.update(_dense(f"{ve}.text_adapter.0", p["text_adapter_fc"]))
    sd.update(_ln(f"{ve}.text_adapter.1", p["text_adapter_ln"]))
    sd[f"{ve}.fusion_token"] = np.asarray(p["fusion_token"])
    sd[f"{ve}.visual_sensor_token_raw_navigation_camera"] = np.asarray(p["nav_camera_token"])
    if "manip_camera_token" in p:
        sd[f"{ve}.visual_sensor_token_raw_manipulation_camera"] = np.asarray(
            p["manip_camera_token"]
        )
    fusion = p["fusion"]
    n_first = np.asarray(fusion["layers"]["norm1"]["scale"]).shape[0] if "layers" in fusion else 0
    for i in range(n_first):
        sd.update(_fusion_layer(f"{ve}.fusion_xformer.layers.{i}", _unstack(fusion["layers"], i)))
    sd.update(_fusion_layer(f"{ve}.fusion_xformer.layers.{n_first}", fusion["layer_last"]))

    sd["last_actions_embed.weight"] = np.asarray(p["prev_action_embed"])
    if "object_in_hand_embed" in p:
        sd["object_in_hand_embed.weight"] = np.asarray(p["object_in_hand_embed"])
    dec = p["decoder"]
    n_dec = np.asarray(dec["layers"]["attention_norm"]["weight"]).shape[0]
    for i in range(n_dec):
        d, pre = _unstack(dec["layers"], i), f"decoder.layers.{i}"
        for name in ("wq", "wk", "wv", "wo"):
            sd.update(_dense(f"{pre}.attention.{name}", d["attention"][name], bias=False))
        for name in ("w1", "w2", "w3"):
            sd.update(_dense(f"{pre}.feed_forward.{name}", d["feed_forward"][name], bias=False))
        sd[f"{pre}.attention_norm.weight"] = np.asarray(d["attention_norm"]["weight"])
        sd[f"{pre}.ffn_norm.weight"] = np.asarray(d["ffn_norm"]["weight"])
    sd["decoder.norm.weight"] = np.asarray(dec["norm"]["weight"])
    sd.update(_dense("decoder.output", dec["output"], bias=False))
    sd.update(_dense("actor.linear", p["actor_head"]))
    if "layers_0" in p["critic_head"]:
        raise NotImplementedError("only the linear critic head is ported yet")
    sd.update(_dense("critic.fc", p["critic_head"]))
    return sd


def policy_state_dict(params_np: Mapping, num_towers: int) -> Dict[str, torch.Tensor]:
    """The whole JAX policy tree -> the port's `SafeVLAPolicy` state dict."""
    sd: Dict[str, np.ndarray] = {}
    sd.update({f"vit.{k}": v for k, v in vit_state_dict(params_np["vit"]).items()})
    sd.update({f"t5.{k}": v for k, v in t5_state_dict(params_np["t5"]).items()})
    towers = _params(params_np["towers"])
    for t in range(num_towers):
        one = tower_state_dict(_unstack(towers, t))
        sd.update({f"towers.{t}.{k}": v for k, v in one.items()})
    return {k: torch.from_numpy(np.ascontiguousarray(v, dtype=np.float32)) for k, v in sd.items()}


@torch.no_grad()
def load_jax_params(policy: SafeVLAPolicy, params_np: Mapping) -> SafeVLAPolicy:
    """Fill `policy` in place from the JAX parameter tree (strict: every
    parameter of the port must be covered, and nothing else given)."""
    policy.load_state_dict(policy_state_dict(params_np, policy.num_towers), strict=True)
    return policy
