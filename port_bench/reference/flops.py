"""The work a step needs, from its shapes: operations for the mfu metrics and
the attention calls for the kernels' roofline.

A frozen copy of the program's analytic count (`algo/flops.py` as of the
port's first benchmark) with one change: recomputed work is not counted.
The program recomputes each fusion chunk's forward in the backward
(checkpointing), so its count takes 4 fusion forwards an epoch; the model
needs 3 (forward, and the backward's two products per forward product).
Multiply-accumulates count 2; heads, GAE and the optimizer are left out.

`attention_bound` and `attention_bwd_bound` are frozen copies of the
roofline arithmetic of the port's kernel smoke test: each input and output
byte counted once, flops at the bf16 tensor-core peak.
"""

from __future__ import annotations

PEAK_BF16_FLOPS = 989e12  # H100 SXM, dense bf16 tensor cores
PEAK_BYTES = 3.35e12  # H100 SXM, HBM3


def fusion_fwd_flops(m: dict, n_samples: int) -> float:
    gh, gw = m["vision_grid"]
    cams = 2
    d, ffn, l = m["hidden_size"], m["fusion_ffn_dim"], m["text_max_tokens"]
    n_tok = 1 + cams * gh * gw + l
    per_layer = n_tok * (8 * d * d + 4 * d * ffn) + 4 * n_tok * n_tok * d
    # the last layer computes q, out-proj and MLP for the fused row only
    last_layer = n_tok * 2 * d * d + (6 * d * d + 4 * d * ffn) + 4 * n_tok * d
    h0, h1 = m["compressor_dims"]
    compressor = cams * gh * gw * 2 * (m["vision_feature_dim"] * h0 + h0 * h1)
    adapters = cams * gh * gw * 2 * h1 * h1 + l * 2 * m["text_embed_size"] * m["goal_dims"]
    return n_samples * ((m["fusion_layers"] - 1) * per_layer + last_layer + compressor + adapters)


def decoder_fwd_flops(m: dict, batch: int, seq: int) -> float:
    d = m["hidden_size"]
    hidden = 256 * ((int(2 * (4 * d) / 3) + 255) // 256)
    per_token = 8 * d * d + 6 * d * hidden + 2 * seq * d
    return batch * seq * (m["decoder_layers"] * per_token + 2 * d * d)


def vit_fwd_flops(v: dict, frames: int) -> float:
    gh, gw = v["image_size"][0] // v["patch_size"], v["image_size"][1] // v["patch_size"]
    n_tok = int(v.get("cls_token", False)) + gh * gw
    d = v["embed_dim"]
    ffn = int(v["mlp_ratio"] * d)
    per_tok_layer = 2 * d * (3 * d) + 2 * d * d + 2 * d * ffn * 2
    matmul = frames * v["depth"] * n_tok * per_tok_layer
    attn = frames * v["depth"] * 4 * n_tok * n_tok * d
    patch = frames * gh * gw * 2 * (3 * v["patch_size"] ** 2) * d
    return matmul + attn + patch


def update_flops(m: dict, towers: int, epochs: int, batch: int, seq: int) -> float:
    """One PPO update: `epochs` x towers x 3 x (fusion + decoder) forwards."""
    fus = fusion_fwd_flops(m, batch * seq)
    dec = decoder_fwd_flops(m, batch, seq)
    return epochs * towers * 3 * (fus + dec)


def bc_step_flops(m: dict, v: dict, towers: int, batch: int, seq: int) -> float:
    """One BC step: the frozen ViT forward on both cameras' frames, then the
    towers' forward and backward."""
    n = batch * seq
    return vit_fwd_flops(v, 2 * n) + towers * 3 * (fusion_fwd_flops(m, n) + decoder_fwd_flops(m, batch, seq))


def attention_bound(b, s, heads, dh, valid_keys, itemsize=2):
    """Least seconds for the attention forward: q.k and p.v over the valid
    keys of every query row at the bf16 peak, against q and out of every
    row plus k and v of the valid rows at the HBM rate."""
    flops = 4.0 * heads * dh * s * valid_keys
    nbytes = itemsize * heads * dh * (2 * b * s + 2 * valid_keys)
    return max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES)


def attention_bwd_bound(b, s, heads, dh, valid_keys, itemsize=2):
    """Least seconds for the attention backward: the five products over the
    valid keys against q and g read, dq, dk, dv written for every row, k and
    v read for the valid rows."""
    flops = 10.0 * heads * dh * s * valid_keys
    nbytes = itemsize * heads * dh * (5 * b * s + 2 * valid_keys)
    return max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES)
