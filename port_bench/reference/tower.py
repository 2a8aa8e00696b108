"""Plain PyTorch policy tower, in float32: SPOC's compressor and adapters,
the fusion transformer (torch `nn.TransformerEncoder` semantics: post-LN,
ReLU MLP, packed in_proj), the LLaMA decoder (RMSNorm, SwiGLU, no rotary;
time enters as a sinusoidal encoding) and the actor / linear critic heads.

Written from the model's description (SafeVLA's
`training/online/dinov2_vits_tsfm_base.py` and SPOC's
`allenact_dino_transformer.py`), not from the program: no kernel, no cache,
no chunked checkpointing, no padding of the token axis. Three choices of
the configuration that differ from torch's defaults are kept: LayerNorm eps
1e-6 everywhere in the tower (torch: 1e-5), RMSNorm eps 1e-5, and the fusion
transformer's output read at its first token only.

`Numerics` holds what the control changes: the control computes in fp8
e4m3 (a per-tensor scale) both operands and the result of every matrix
product and the fusion's normalised stream; the reference rounds nothing.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Dict, Optional

import torch
import torch.nn.functional as F

Tensor = torch.Tensor


def _identity(x: Tensor) -> Tensor:
    return x


def fp8_round(x: Tensor) -> Tensor:
    """x rounded to float8 e4m3 with a per-tensor scale (its amax to 448),
    as fp8 training recipes scale; the gradient passes straight through."""
    amax = x.detach().abs().amax().float().clamp(min=1e-12)
    scale = 448.0 / amax
    q = (x.detach().float() * scale).to(torch.float8_e4m3fn).float() / scale
    return x + (q.to(x.dtype) - x).detach()


@dataclass(frozen=True)
class Numerics:
    """`round` is applied to both operands and to the result of every matrix
    product (a bias added first), and to the activations `act` is given."""

    round: Callable[[Tensor], Tensor] = _identity

    def linear(self, x: Tensor, w: Tensor, b: Optional[Tensor] = None) -> Tensor:
        y = self.round(x) @ self.round(w).t()
        return self.round(y if b is None else y + b)

    def bmm(self, a: Tensor, b: Tensor) -> Tensor:
        return self.round(self.round(a) @ self.round(b))

    def act(self, x: Tensor) -> Tensor:
        return self.round(x)


F32 = Numerics()
FP8 = Numerics(fp8_round)


def layer_norm(x: Tensor, w: Tensor, b: Tensor, eps: float) -> Tensor:
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) / torch.sqrt(var + eps) * w + b


def rms_norm(x: Tensor, w: Tensor, eps: float) -> Tensor:
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * w


def attention(nm: Numerics, q: Tensor, k: Tensor, v: Tensor, allowed: Optional[Tensor]) -> Tensor:
    """q, k, v (N, H, S, Dh); allowed broadcastable to (N, H, Sq, Sk) bool."""
    logits = nm.bmm(q, k.transpose(-1, -2)) / math.sqrt(q.shape[-1])
    if allowed is not None:
        logits = logits.masked_fill(~allowed, float("-inf"))
    return nm.bmm(torch.softmax(logits, dim=-1), v)


def heads(x: Tensor, h: int) -> Tensor:
    n, s, d = x.shape
    return x.reshape(n, s, h, d // h).transpose(1, 2)


def merge(x: Tensor) -> Tensor:
    n, h, s, dh = x.shape
    return x.transpose(1, 2).reshape(n, s, h * dh)


def sinusoid(position: Tensor, d: int) -> Tensor:
    """sin on even channels, cos on odd, 10000^(-2i/d) frequencies."""
    freq = torch.exp(torch.arange(0, d, 2, dtype=torch.float32, device=position.device) * (-math.log(10000.0) / d))
    ang = position[..., None].float() * freq
    return torch.stack([torch.sin(ang), torch.cos(ang)], dim=-1).flatten(-2)


class Tower:
    """One tower's weights (names relative to the tower) and its forward."""

    def __init__(self, w: Dict[str, Tensor], m: dict, nm: Numerics = F32):
        self.w, self.m, self.nm = w, m, nm

    def _lin(self, x, name, bias=True):
        return self.nm.linear(x, self.w[name + ".weight"], self.w[name + ".bias"] if bias else None)

    def _camera(self, feat: Tensor, token: Tensor) -> Tensor:
        """feat (N, gh, gw, Dv) -> (N, gh*gw, goal) camera tokens."""
        ve, nm = "visual_encoder.", self.nm
        x = feat.reshape(feat.shape[0], -1, feat.shape[-1])
        for i in (0, 2):
            w = self.w[f"{ve}visual_compressor.{i}.weight"].flatten(1)
            x = F.relu(nm.linear(x, w, self.w[f"{ve}visual_compressor.{i}.bias"]))
        x = self._lin(x, ve + "visual_adapter.0")
        x = F.relu(layer_norm(x, self.w[ve + "visual_adapter.1.weight"], self.w[ve + "visual_adapter.1.bias"], 1e-6))
        return x + token

    def embed(self, dino_nav: Tensor, dino_manip: Tensor, text_h: Tensor, text_m: Tensor) -> Tensor:
        """Per-step fusion: (N, gh, gw, Dv) x2, (N, L, Dt), (N, L) bool -> (N, D)."""
        ve, m, w = "visual_encoder.", self.m, self.w
        n = dino_nav.shape[0]
        txt = self._lin(text_h, ve + "text_adapter.0")
        txt = F.relu(layer_norm(txt, w[ve + "text_adapter.1.weight"], w[ve + "text_adapter.1.bias"], 1e-6))
        x = torch.cat(
            [
                w[ve + "fusion_token"].expand(n, 1, -1),
                self._camera(dino_nav, w[ve + "visual_sensor_token_raw_navigation_camera"]),
                self._camera(dino_manip, w[ve + "visual_sensor_token_raw_manipulation_camera"]),
                txt * text_m[..., None],
            ],
            dim=1,
        )
        s = x.shape[1]
        valid = torch.cat([torch.ones(n, s - text_m.shape[1], dtype=torch.bool, device=x.device), text_m], 1)
        allowed = valid[:, None, None, :]
        h = m["fusion_heads"]
        for i in range(m["fusion_layers"]):
            p = f"{ve}fusion_xformer.layers.{i}."
            qkv = self.nm.linear(x, w[p + "self_attn.in_proj_weight"], w[p + "self_attn.in_proj_bias"])
            q, k, v = (heads(t, h) for t in qkv.chunk(3, dim=-1))
            a = self._lin(merge(attention(self.nm, q, k, v, allowed)), p + "self_attn.out_proj")
            x = self.nm.act(layer_norm(x + a, w[p + "norm1.weight"], w[p + "norm1.bias"], 1e-6))
            y = self._lin(F.relu(self._lin(x, p + "linear1")), p + "linear2")
            x = self.nm.act(layer_norm(x + y, w[p + "norm2.weight"], w[p + "norm2.bias"], 1e-6))
        return x[:, 0]

    def decode(self, obs: Tensor, prev_actions: Tensor, not_reset: Tensor, object_in_hand: Tensor,
               time_step: Tensor, traj_idx: Tensor):
        """(B, T, D) embeddings and (B, T) step data -> (logits, values)."""
        m, w, nm = self.m, self.w, self.nm
        d, h = m["hidden_size"], m["decoder_heads"]
        prev = torch.where(not_reset != 0, prev_actions, m["num_actions"]).long()
        x = obs + w["last_actions_embed.weight"][prev] + w["object_in_hand_embed.weight"][object_in_hand.long()]
        x = x + sinusoid(time_step, d)
        t = x.shape[1]
        same = traj_idx[:, :, None] == traj_idx[:, None, :]
        causal = torch.ones(t, t, dtype=torch.bool, device=x.device).tril()
        allowed = (same & causal)[:, None]
        for i in range(m["decoder_layers"]):
            p = f"decoder.layers.{i}."
            a = rms_norm(x, w[p + "attention_norm.weight"], 1e-5)
            q, k, v = (heads(self._lin(a, p + f"attention.{n}", bias=False), h) for n in ("wq", "wk", "wv"))
            x = x + self._lin(merge(attention(nm, q, k, v, allowed)), p + "attention.wo", bias=False)
            f = rms_norm(x, w[p + "ffn_norm.weight"], 1e-5)
            gate = F.silu(self._lin(f, p + "feed_forward.w1", bias=False)) * self._lin(f, p + "feed_forward.w3", bias=False)
            x = x + self._lin(gate, p + "feed_forward.w2", bias=False)
        beliefs = self._lin(rms_norm(x, w["decoder.norm.weight"], 1e-5), "decoder.output", bias=False)
        return self._lin(beliefs, "actor.linear"), self._lin(beliefs, "critic.fc")[..., 0]


def split_towers(weights: Dict[str, Tensor], towers: int):
    """{"<t>.<name>": w} -> one {name: w} per tower."""
    return [{k[len(f"{t}.") :]: v for k, v in weights.items() if k.startswith(f"{t}.")} for t in range(towers)]


def fusion_params(names):
    """The names read only by `Tower.embed` (the per-step fusion)."""
    return [n for n in names if n.split(".", 1)[-1].startswith("visual_encoder.")]
