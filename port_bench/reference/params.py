"""The parameters of each model the benchmark runs, and the seeded weights
that both sides receive.

`tower_spec`, `vit_spec` and `text_spec` list every parameter of a policy
tower, a ViT trunk and a SigLIP text tower as (name, shape, served dtype,
family), from the configuration file's `model` section alone. The names are
the state-dict names of the reference torch modules (SPOC's towers,
timm / torch-hub ViTs, open_clip's text transformer), which the program
loads by name; a strict load checks that the two agree.

`make_weights` draws all of a spec's values in one call on the device from
the seed and shapes them by family; `stream_seed` and `spread` are the
seeded draws the drivers share. A parameter served in bf16 is rounded
to bf16 here, so that the program, which stores it in bf16, and the
reference, which computes in f32, hold the same values.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

Spec = List[Tuple[str, Tuple[int, ...], str, str]]


def ffn_hidden(dim: int, multiple_of: int = 256) -> int:
    """The LLaMA SwiGLU width: 2/3 of 4 * dim, rounded up to a multiple of 256."""
    hidden = int(2 * (4 * dim) / 3)
    return multiple_of * ((hidden + multiple_of - 1) // multiple_of)


def tower_spec(m: dict) -> Spec:
    """One policy tower: compressor, adapters, learned tokens, the fusion
    transformer, prev-action / object-in-hand embeddings, the LLaMA decoder,
    actor and linear critic heads."""
    d, g, dv, dt = m["hidden_size"], m["goal_dims"], m["vision_feature_dim"], m["text_embed_size"]
    h0, h1 = m["compressor_dims"]
    ffn, a = m["fusion_ffn_dim"], m["num_actions"]
    ve = "visual_encoder."
    spec: Spec = [
        (ve + "fusion_token", (g,), "float32", "token"),
        (ve + "visual_sensor_token_raw_navigation_camera", (g,), "float32", "token"),
        (ve + "visual_sensor_token_raw_manipulation_camera", (g,), "float32", "token"),
        (ve + "visual_compressor.0.weight", (h0, dv, 1, 1), "float32", "dense"),
        (ve + "visual_compressor.0.bias", (h0,), "float32", "bias"),
        (ve + "visual_compressor.2.weight", (h1, h0, 1, 1), "float32", "dense"),
        (ve + "visual_compressor.2.bias", (h1,), "float32", "bias"),
        (ve + "visual_adapter.0.weight", (h1, h1), "float32", "dense"),
        (ve + "visual_adapter.0.bias", (h1,), "float32", "bias"),
        (ve + "visual_adapter.1.weight", (h1,), "float32", "norm"),
        (ve + "visual_adapter.1.bias", (h1,), "float32", "bias"),
        (ve + "text_adapter.0.weight", (g, dt), "float32", "dense"),
        (ve + "text_adapter.0.bias", (g,), "float32", "bias"),
        (ve + "text_adapter.1.weight", (g,), "float32", "norm"),
        (ve + "text_adapter.1.bias", (g,), "float32", "bias"),
    ]
    for i in range(m["fusion_layers"]):
        p = f"{ve}fusion_xformer.layers.{i}."
        spec += [
            (p + "self_attn.in_proj_weight", (3 * d, d), "float32", "dense"),
            (p + "self_attn.in_proj_bias", (3 * d,), "float32", "bias"),
            (p + "self_attn.out_proj.weight", (d, d), "float32", "dense"),
            (p + "self_attn.out_proj.bias", (d,), "float32", "bias"),
            (p + "linear1.weight", (ffn, d), "float32", "dense"),
            (p + "linear1.bias", (ffn,), "float32", "bias"),
            (p + "linear2.weight", (d, ffn), "float32", "dense"),
            (p + "linear2.bias", (d,), "float32", "bias"),
            (p + "norm1.weight", (d,), "float32", "norm"),
            (p + "norm1.bias", (d,), "float32", "bias"),
            (p + "norm2.weight", (d,), "float32", "norm"),
            (p + "norm2.bias", (d,), "float32", "bias"),
        ]
    spec += [
        ("last_actions_embed.weight", (a + 2, d), "float32", "embed"),
        ("object_in_hand_embed.weight", (3, d), "float32", "embed"),
    ]
    hid = ffn_hidden(d)
    for i in range(m["decoder_layers"]):
        p = f"decoder.layers.{i}."
        spec += [(p + f"attention.{w}.weight", (d, d), "float32", "dense") for w in ("wq", "wk", "wv", "wo")]
        spec += [
            (p + "feed_forward.w1.weight", (hid, d), "float32", "dense"),
            (p + "feed_forward.w2.weight", (d, hid), "float32", "dense"),
            (p + "feed_forward.w3.weight", (hid, d), "float32", "dense"),
            (p + "attention_norm.weight", (d,), "float32", "norm"),
            (p + "ffn_norm.weight", (d,), "float32", "norm"),
        ]
    spec += [
        ("decoder.norm.weight", (d,), "float32", "norm"),
        ("decoder.output.weight", (d, d), "float32", "dense"),
        ("actor.linear.weight", (a, d), "float32", "head"),
        ("actor.linear.bias", (a,), "float32", "bias"),
        ("critic.fc.weight", (1, d), "float32", "dense"),
        ("critic.fc.bias", (1,), "float32", "bias"),
    ]
    return spec


def towers_spec(m: dict, towers: int) -> Spec:
    return [(f"{t}.{n}", s, dt, f) for t in range(towers) for n, s, dt, f in tower_spec(m)]


def vit_spec(v: dict) -> Spec:
    """A patch-only ViT trunk without LayerScale (SigLIP's): conv patch
    embedding, learned positions, pre-LN blocks, the final norm; linear
    layers served in `dtype` (bf16 unless the file says otherwise)."""
    d, p, n = v["embed_dim"], v["patch_size"], (v["image_size"][0] // v["patch_size"]) * (v["image_size"][1] // v["patch_size"])
    hid, lin = int(d * v["mlp_ratio"]), v.get("dtype", "bfloat16")
    spec: Spec = [
        ("patch_embed.proj.weight", (d, 3, p, p), "float32", "dense"),
        ("patch_embed.proj.bias", (d,), "float32", "bias"),
        ("pos_embed", (1, n, d), "float32", "pos"),
    ]
    for i in range(v["depth"]):
        b = f"blocks.{i}."
        spec += [
            (b + "norm1.weight", (d,), "float32", "norm"),
            (b + "norm1.bias", (d,), "float32", "bias"),
            (b + "attn.qkv.weight", (3 * d, d), lin, "dense"),
            (b + "attn.qkv.bias", (3 * d,), lin, "bias"),
            (b + "attn.proj.weight", (d, d), lin, "dense"),
            (b + "attn.proj.bias", (d,), lin, "bias"),
            (b + "norm2.weight", (d,), "float32", "norm"),
            (b + "norm2.bias", (d,), "float32", "bias"),
            (b + "mlp.fc1.weight", (hid, d), lin, "dense"),
            (b + "mlp.fc1.bias", (hid,), lin, "bias"),
            (b + "mlp.fc2.weight", (d, hid), lin, "dense"),
            (b + "mlp.fc2.bias", (d,), lin, "bias"),
        ]
    spec += [("norm.weight", (d,), "float32", "norm"), ("norm.bias", (d,), "float32", "bias")]
    return spec


def text_spec(t: dict) -> Spec:
    """open_clip's text transformer as SigLIP uses it."""
    d, hid, lin = t["d_model"], int(t["d_model"] * t["mlp_ratio"]), t.get("dtype", "bfloat16")
    spec: Spec = [
        ("token_embedding.weight", (t["vocab_size"], d), "float32", "pos"),
        ("positional_embedding", (t["max_tokens"], d), "float32", "pos"),
    ]
    for i in range(t["num_layers"]):
        b = f"transformer.resblocks.{i}."
        spec += [
            (b + "ln_1.weight", (d,), "float32", "norm"),
            (b + "ln_1.bias", (d,), "float32", "bias"),
            (b + "attn.in_proj_weight", (3 * d, d), lin, "dense"),
            (b + "attn.in_proj_bias", (3 * d,), lin, "bias"),
            (b + "attn.out_proj.weight", (d, d), lin, "dense"),
            (b + "attn.out_proj.bias", (d,), lin, "bias"),
            (b + "ln_2.weight", (d,), "float32", "norm"),
            (b + "ln_2.bias", (d,), "float32", "bias"),
            (b + "mlp.c_fc.weight", (hid, d), lin, "dense"),
            (b + "mlp.c_fc.bias", (hid,), lin, "bias"),
            (b + "mlp.c_proj.weight", (d, hid), lin, "dense"),
            (b + "mlp.c_proj.bias", (d,), lin, "bias"),
        ]
    spec += [("ln_final.weight", (d,), "float32", "norm"), ("ln_final.bias", (d,), "float32", "bias")]
    return spec


def stream_seed(seed: int, stream: int) -> int:
    """A generator seed for one purpose (weights, traffic, ...) of a run's seed."""
    return (int(seed) * 1_000_003 + 7919 * int(stream)) % (2**63 - 1)


def spread(lo: int, hi: int, n: int) -> List[int]:
    """n whole numbers evenly from lo to hi: a set of sizes every seed shares."""
    return [lo + (hi - lo) * i // max(n - 1, 1) for i in range(n)]


def _shape(x: torch.Tensor, shape, family: str) -> torch.Tensor:
    """A standard normal draw -> the family's distribution. Biases and norm
    offsets are small and nonzero, so that a path that drops them shows."""
    if family == "dense":
        fan_in = 1
        for s in shape[1:]:
            fan_in *= s
        return x * fan_in**-0.5
    if family == "head":  # the actor head starts near-uniform, as SPOC's orthogonal(0.01)
        return x * (0.01 * shape[1] ** -0.5)
    if family == "bias":
        return x * 0.02
    if family == "norm":
        return 1.0 + 0.05 * x
    if family == "token":
        return 0.1 * x
    if family == "embed":
        return 0.05 * x
    if family == "pos":
        return 0.02 * x
    raise ValueError(f"unknown parameter family {family!r}")


@torch.no_grad()
def make_weights(spec: Spec, seed: int, stream: int, device) -> Dict[str, torch.Tensor]:
    """name -> f32 tensor on `device`, every value drawn in one call from
    the seed's generator; bf16-served parameters hold bf16 values."""
    g = torch.Generator(device=device).manual_seed(stream_seed(seed, stream))
    sizes = []
    for _, shape, _, _ in spec:
        n = 1
        for s in shape:
            n *= s
        sizes.append(n)
    flat = torch.randn(sum(sizes), generator=g, device=device, dtype=torch.float32)
    out, off = {}, 0
    for (name, shape, dtype, family), n in zip(spec, sizes):
        w = _shape(flat[off : off + n].view(shape), shape, family)
        if dtype == "bfloat16":
            w = w.to(torch.bfloat16).float()
        out[name] = w.contiguous()
        off += n
    return out


def served(weights: Dict[str, torch.Tensor], spec: Spec) -> Dict[str, torch.Tensor]:
    """The weights in the dtypes the program stores them in (for a strict load)."""
    dt = {name: getattr(torch, dtype) for name, _, dtype, _ in spec}
    return {k: v.to(dt[k]) for k, v in weights.items()}
