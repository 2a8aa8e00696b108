"""SafeVLA policy: frozen image features -> fusion transformer -> causal
decoder -> actor / reward-critic / cost-critic.

Counterpart of `safevla_tpu/models/actor_critic.py`: the frozen encoders
(`vision_backbone`: a DINOv2 / SigLIP ViT or the CLIP ResNet-50;
`text_backbone`: T5 or the SigLIP text tower, kept under the name `t5` as
the JAX package keeps its params key), the serving path
(`act_step`, `init_state`, `update_text`), one tower's full-sequence
forward (`PolicyTower.full_seq`), the update's full-sequence
forward (`forward_seq`: fusion over the packed B*T samples in recomputed
chunks, `models/fusion_pass.py`, then the decoder over the packed
block-causal mask, then the heads)
and its chunk-granular pieces for the async pipeline (`embed_time_range`:
the fusion over a range of time steps of every stream; `decode_from_embeds`:
decoder and heads over a buffer of those embeddings), and `acting_copy`, the
policy the async pipeline's rollout acts with (towers of its own, the frozen
encoders shared). Three `PolicyTower` modules run one after another
(the JAX package vmaps one tower over stacked parameters); logits come from
tower 0, values from tower 1, cost values from tower 2. Trainable tower
parameters are f32 and cast to the compute dtype at use, as flax's Dense
(`models/dense.py`). The critic head is `cfg.critic_type`'s: `linear` (one
Dense), `mlp` (Dense 256 - relu - Dense 256 - relu - Dense 1) or `discrete`
(Dense 256 - relu - Dense bins: the HL-Gauss histogram's logits, read out by
`ops/hl_gauss.py`). Tower modules carry the reference's torch state-dict
names (`visual_encoder.fusion_xformer...`, `last_actions_embed`,
`decoder.layers.N...`, `actor.linear`, `critic.fc`, or the Sequential's
`critic.fc.0/2/4`); the reference prefixes its critic towers with
`critic_tsfm.` and `c_critic_tsfm.`, which are `towers.1.` and `towers.2.`
here.
"""

from __future__ import annotations

import copy
import dataclasses
import math
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from safevla_tpu_torch import resolve_device
from safevla_tpu_torch.config import ModelConfig
from safevla_tpu_torch.models.dense import Dense, cast_param
from safevla_tpu_torch.models.fusion import FusionTransformer, TorchMultiheadAttention
from safevla_tpu_torch.models.fusion_pass import fusion_pass
from safevla_tpu_torch.models.image_encoders import build_image_encoder
from safevla_tpu_torch.models.llama_decoder import DecoderConfig, LlamaDecoder, RMSNorm
from safevla_tpu_torch.models.norms import CompatLayerNorm, PlainLayerNorm
from safevla_tpu_torch.models.resnet import FrozenBatchNorm
from safevla_tpu_torch.models.t5 import T5Config, T5Encoder, T5LayerNorm
from safevla_tpu_torch.models.text_towers import SigLIPTextEncoder, TextTowerConfig, TextAttention
from safevla_tpu_torch.models.vit import DinoViT, LayerScale
from safevla_tpu_torch.ops.hl_gauss import HLGauss
from safevla_tpu_torch.ops.masks import incremental_episode_mask, packed_block_causal_mask
from safevla_tpu_torch.utils.profiling import span


def sinusoidal_time_encoding(position: torch.Tensor, d_model: int) -> torch.Tensor:
    """position (...,) int/float -> (..., d_model) f32, sin on even and cos on
    odd channels (reference text_cond_visual_encoder.py:263-285)."""
    div_term = torch.exp(
        torch.arange(0, d_model, 2, dtype=torch.float32, device=position.device)
        * (-math.log(10000.0) / d_model)
    )
    angles = position[..., None].float() * div_term
    pe = torch.zeros(position.shape + (d_model,), dtype=torch.float32, device=position.device)
    pe[..., 0::2] = torch.sin(angles)
    pe[..., 1::2] = torch.cos(angles)
    return pe


class VisualEncoder(nn.Module):
    """Compressor, adapters, learned tokens and the fusion transformer of one
    tower (the reference's `visual_encoder.*`)."""

    def __init__(self, c: ModelConfig, dtype: torch.dtype):
        super().__init__()
        self.dtype = dtype
        h0, h1 = c.dino_compressor_hidden_out_dims
        # 1x1 convs on the (7, 12) grid; applied as matmuls on channels-last
        self.visual_compressor = nn.Sequential(
            nn.Conv2d(c.vision_feature_dim, h0, 1), nn.ReLU(),
            nn.Conv2d(h0, h1, 1), nn.ReLU(),
        )
        # reference adapter order: Linear, LayerNorm (f32, eps 1e-6), ReLU;
        # flax nn.LayerNorm in the JAX package, never the LayerNorm kernel
        self.visual_adapter = nn.Sequential(
            Dense(h1, h1, compute_dtype=dtype), PlainLayerNorm(h1), nn.ReLU()
        )
        self.text_adapter = nn.Sequential(
            Dense(c.text_embed_size, c.goal_dims, compute_dtype=dtype),
            PlainLayerNorm(c.goal_dims),
            nn.ReLU(),
        )
        self.fusion_token = nn.Parameter(torch.zeros(c.goal_dims))
        self.visual_sensor_token_raw_navigation_camera = nn.Parameter(torch.zeros(c.goal_dims))
        if c.use_manipulation_camera:
            self.visual_sensor_token_raw_manipulation_camera = nn.Parameter(
                torch.zeros(c.goal_dims)
            )
        self.fusion_xformer = FusionTransformer(
            dim=c.hidden_size,
            num_heads=c.combiner_heads,
            num_layers=c.combiner_layers,
            ffn_dim=c.combiner_ffn_dim,
            dtype=dtype,
        )

    def camera_tokens(self, feat, cam_token):
        """feat (N, gh, gw, Dv) -> (N, gh*gw, goal_dims) tokens + camera token."""
        dt = self.dtype
        x = feat.to(dt)
        for conv in (self.visual_compressor[0], self.visual_compressor[2]):
            w, b = cast_param(conv.weight, dt).flatten(1), cast_param(conv.bias, dt)
            x = F.relu(F.linear(x, w, b))
        x = x.reshape(feat.shape[0], -1, x.shape[-1])
        x = self.visual_adapter(x).to(self.dtype)
        return x + cam_token.to(self.dtype)


class ActorHead(nn.Module):
    def __init__(self, dim: int, num_actions: int):
        super().__init__()
        self.linear = nn.Linear(dim, num_actions)  # f32


class CriticHead(nn.Module):
    """`fc`: the linear head, or the mlp / discrete heads' Sequential (f32)."""

    def __init__(self, dim: int, critic_type: str = "linear", bins: int = 1):
        super().__init__()
        if critic_type == "linear":
            self.fc = nn.Linear(dim, 1)
        elif critic_type == "mlp":
            self.fc = nn.Sequential(
                nn.Linear(dim, 256), nn.ReLU(), nn.Linear(256, 256), nn.ReLU(), nn.Linear(256, 1)
            )
        elif critic_type == "discrete":
            self.fc = nn.Sequential(nn.Linear(dim, 256), nn.ReLU(), nn.Linear(256, bins))
        else:
            raise ValueError(f"Unknown critic type {critic_type}")


class PolicyTower(nn.Module):
    """One trainable tower: compressor + fusion + decoder + heads. Frozen
    encoder outputs come in as tensors."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        self.dtype = getattr(torch, cfg.compute_dtype)
        d = cfg.hidden_size
        self.visual_encoder = VisualEncoder(cfg, self.dtype)
        # prev-action vocabulary: A actions + null token (index A) + padding
        self.last_actions_embed = nn.Embedding(cfg.num_actions + 2, d)
        if cfg.use_object_in_hand:
            self.object_in_hand_embed = nn.Embedding(3, d)
        self.decoder = LlamaDecoder(self.decoder_config())
        self.actor = ActorHead(d, cfg.num_actions)
        self.critic = CriticHead(d, cfg.critic_type, cfg.hl_gauss_bins)
        self.hl = HLGauss(cfg.hl_gauss_min, cfg.hl_gauss_max, cfg.hl_gauss_bins, cfg.hl_gauss_sigma)

    def decoder_config(self) -> DecoderConfig:
        c = self.cfg
        return DecoderConfig(
            dim=c.hidden_size,
            n_layers=c.num_tx_layers,
            n_heads=c.num_tx_heads,
            max_seq_len=c.max_steps,
            dtype=self.dtype,
        )

    def _fuse(self, dino_nav, dino_manip, text_hidden, text_mask):
        """dino_* (N, gh, gw, Dv), text_hidden (N, L, Dt), text_mask (N, L)
        -> fused CLS (N, D) f32."""
        c, ve, dt = self.cfg, self.visual_encoder, self.dtype
        n = dino_nav.shape[0]
        toks = [
            ve.fusion_token.to(dt).expand(n, 1, c.goal_dims),
            ve.camera_tokens(dino_nav, ve.visual_sensor_token_raw_navigation_camera),
        ]
        if c.use_manipulation_camera and dino_manip is not None:
            toks.append(
                ve.camera_tokens(dino_manip, ve.visual_sensor_token_raw_manipulation_camera)
            )
        txt = ve.text_adapter(text_hidden.to(dt)).to(dt)
        toks.append(txt * text_mask[..., None].to(dt))
        # right-padded text: the valid keys are a prefix, passed as counts
        n_prefix = sum(t.shape[1] for t in toks[:-1])
        key_lens = n_prefix + text_mask.sum(dim=-1, dtype=torch.int32)
        tokens = torch.cat(toks, dim=1)
        # pad once to a multiple of 16 (201 -> 208); key_lens masks the pad
        pad = -tokens.shape[1] % 16
        if pad:
            tokens = F.pad(tokens, (0, 0, 0, pad))
        fused = ve.fusion_xformer(tokens, key_lens=key_lens, out_rows=1)
        return fused[:, 0].float()

    def _joint_embed(self, obs_embeds, prev_actions, not_reset, object_in_hand, time_step):
        """All (B, T, ...) -> decoder inputs (B, T, D) f32."""
        c = self.cfg
        prev = torch.where(not_reset != 0, prev_actions, c.num_actions)  # null token
        joint = obs_embeds + self.last_actions_embed.weight[prev.long()]
        if c.use_object_in_hand and object_in_hand is not None:
            joint = joint + self.object_in_hand_embed.weight[object_in_hand.long()]
        return joint + sinusoidal_time_encoding(time_step, c.hidden_size)

    def _critic(self, beliefs):
        """The critic head: values (linear, mlp) or value logits (discrete)."""
        out = self.critic.fc(beliefs)
        return out if self.cfg.critic_type == "discrete" else out[..., 0]

    def _heads(self, beliefs):
        """-> (logits, values, value logits: None unless discrete)."""
        logits = self.actor.linear(beliefs)
        if self.cfg.critic_type == "discrete":
            value_logits = self._critic(beliefs)
            return logits, self.hl.from_logits(value_logits), value_logits
        return logits, self._critic(beliefs), None

    def full_seq(
        self,
        dino_nav,  # (B, T, gh, gw, Dv)
        dino_manip,  # (B, T, gh, gw, Dv) or None
        text_hidden,  # (B, E, L, Dt) with text_idx, (B, T, L, Dt) or (B, L, Dt)
        text_mask,  # the matching (..., L) bool
        prev_actions,  # (B, T) int
        not_reset,  # (B, T); 0 marks episode starts
        object_in_hand,  # (B, T) int or None
        time_step,  # (B, T) int in-episode step index
        attn_mask,  # (B, 1, T, T) bool
        text_idx=None,  # (B, T) int into the episode table
    ):
        """This tower's full-sequence forward in one piece (JAX
        `PolicyTower.full_seq`): the fusion over all B*T steps, then
        `decode_heads`, whose outputs it returns. `SafeVLAPolicy.forward_seq`
        runs the same math with the fusion in recomputed chunks."""
        b, t = dino_nav.shape[:2]
        flat = lambda x: None if x is None else x.reshape((b * t,) + x.shape[2:])
        text_h, text_m = _flat_text(text_hidden, text_mask, text_idx, b, t)
        fused = self.embed_obs(flat(dino_nav), flat(dino_manip), text_h, text_m)
        return self.decode_heads(
            fused.reshape(b, t, -1), prev_actions, not_reset, object_in_hand, time_step, attn_mask
        )

    def embed_obs(self, dino_nav_flat, dino_manip_flat, text_h, text_m):
        """Per-step fusion embedding over a flat (N, ...) batch -> (N, D) f32.
        Per-step independent, so forward_seq runs it in chunks, recomputed
        in the backward (`models/fusion_pass.py`). The span `model.fusion`
        (the recompute opens it again)."""
        with span("model.fusion"):
            return self._fuse(dino_nav_flat, dino_manip_flat, text_h, text_m)

    def decode_heads(self, obs_embeds, prev_actions, not_reset, object_in_hand, time_step, attn_mask):
        """(B, T, D) observation embeddings -> full-sequence decoder + heads:
        (logits, values, value logits (None unless discrete), the critic
        head on stop-gradient beliefs: values, or value logits if discrete)."""
        joint = self._joint_embed(obs_embeds, prev_actions, not_reset, object_in_hand, time_step)
        beliefs = self.decoder.full(joint, attn_mask)
        logits, values, value_logits = self._heads(beliefs)
        return logits, values, value_logits, self._critic(beliefs.detach())

    def step(
        self,
        dino_nav,  # (B, gh, gw, Dv)
        dino_manip,
        text_hidden,  # (B, L, Dt)
        text_mask,  # (B, L)
        prev_actions,  # (B,)
        not_reset,  # (B,)
        object_in_hand,  # (B,)
        time_step,  # (B,)
        cache_k,  # (L, B, S, H, Dh), written in place
        cache_v,
        pos: int,  # shared cache write slot
        max_steps: int,
    ):
        fused = self._fuse(dino_nav, dino_manip, text_hidden, text_mask)
        joint = self._joint_embed(
            fused[:, None],
            prev_actions[:, None],
            not_reset[:, None],
            object_in_hand[:, None] if object_in_hand is not None else None,
            time_step[:, None],
        )
        mask = incremental_episode_mask(time_step, pos, max_steps)
        beliefs = self.decoder.step(joint, cache_k, cache_v, pos, mask)
        logits, values, _ = self._heads(beliefs)
        return logits[:, 0], values[:, 0]


@dataclass
class PolicyOutputs:
    logits: torch.Tensor  # (B, T, A) from the actor tower
    values: torch.Tensor  # (B, T) reward critic
    c_values: Optional[torch.Tensor]  # (B, T) cost critic (None if num_towers < 3)
    value_logits: Optional[torch.Tensor]  # discrete critic only
    c_value_logits: Optional[torch.Tensor]
    stop_grad_values: Optional[torch.Tensor]
    extras: Dict[str, Any]


def _flat_text(text_hidden, text_mask, text_idx, b: int, t: int):
    """Per-step instruction encodings flattened b-major to (B*T, L, D), from
    one of three layouts: a (B, E, L, D) episode table indexed by text_idx
    (B, T); per-step (B, T, L, D); one (B, L, D) per stream."""
    n = b * t
    if text_idx is not None:
        rows = torch.arange(b, device=text_idx.device)[:, None]
        idx = text_idx.long()
        return (
            text_hidden[rows, idx].reshape((n,) + text_hidden.shape[2:]),
            text_mask[rows, idx].reshape(n, -1),
        )
    if text_hidden.dim() == 4:
        return text_hidden.reshape((n,) + text_hidden.shape[2:]), text_mask.reshape(n, -1)
    return text_hidden.repeat_interleave(t, dim=0), text_mask.repeat_interleave(t, dim=0)


@dataclass
class PolicyState:
    """Carried rollout state. The cache tensors are updated in place by
    `act_step`; the other fields are replaced."""

    cache: Dict[str, torch.Tensor]  # k/v: (towers, L, B, S, H, Dh)
    pos: int  # shared cache write slot
    time_step: torch.Tensor  # (B,) int32 in-episode step counter
    text_hidden: torch.Tensor  # (B, L, Dt) cached frozen T5 encoding
    text_mask: torch.Tensor  # (B, L) bool


class SafeVLAPolicy(nn.Module):
    """Frozen encoders + the policy towers.

    Built on the CPU, filled from `generator` (a seeded default when None),
    then moved to `device`. `device="cuda"` raises when CUDA is absent."""

    def __init__(
        self,
        cfg: ModelConfig,
        device="cuda",
        generator: Optional[torch.Generator] = None,
    ):
        device = resolve_device(device)
        super().__init__()
        self.cfg = cfg
        self.vit = build_image_encoder(cfg.vision_backbone)
        # the frozen text tower: T5, or the SigLIP text transformer (its
        # heads: the first of 12, 8, 6, 4, 2, 1 that divides the width, as
        # JAX); the attribute stays `t5`, as JAX's params key
        if "siglip" in cfg.text_backbone.lower():
            heads = next(h for h in (12, 8, 6, 4, 2, 1) if cfg.text_embed_size % h == 0)
            self.t5 = SigLIPTextEncoder(
                TextTowerConfig(d_model=cfg.text_embed_size, num_heads=heads, max_tokens=cfg.text_max_tokens)
            )
        else:
            self.t5 = T5Encoder(T5Config(d_model=cfg.text_embed_size))
        self.towers = nn.ModuleList(PolicyTower(cfg) for _ in range(cfg.num_towers))
        self.num_towers = cfg.num_towers
        self.init_params(generator or torch.Generator().manual_seed(0))
        self.to(device)

    @property
    def device(self) -> torch.device:
        # a weight every policy has, whatever its backbones
        return self.towers[0].actor.linear.weight.device

    @torch.no_grad()
    def init_params(self, generator: torch.Generator) -> None:
        """Random weights from `generator`, with the JAX package's init
        families (lecun-normal dense and conv kernels, zero biases, unit
        norms, xavier in_proj in the fusion, orthogonal heads, small uniform
        embeddings; the SigLIP text tower's token and position embeddings
        normal(0.02) and normal(0.01); BatchNorm the identity)."""
        g = generator

        def normal(p, std):
            p.copy_(torch.randn(p.shape, generator=g) * std)

        def uniform(p, lo, hi):
            p.copy_(torch.rand(p.shape, generator=g) * (hi - lo) + lo)

        def orthogonal(p, gain):
            rows, cols = p.shape
            a = torch.randn(max(rows, cols), min(rows, cols), generator=g)
            qm, r = torch.linalg.qr(a)
            qm = qm * torch.sign(torch.diagonal(r))
            p.copy_(gain * (qm if rows >= cols else qm.T))

        for m in self.modules():
            if isinstance(m, (nn.Linear, nn.Conv2d)):
                normal(m.weight, m.weight[0].numel() ** -0.5)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, nn.Embedding):
                normal(m.weight, 1.0)
            elif isinstance(m, CompatLayerNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()
            elif isinstance(m, (RMSNorm, T5LayerNorm)):
                m.weight.fill_(1.0)
            elif isinstance(m, FrozenBatchNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()
                m.running_mean.zero_()
                m.running_var.fill_(1.0)
        # module-specific families, after the generic pass
        for m in self.modules():
            if isinstance(m, LayerScale):
                m.gamma.fill_(1e-5)
            elif isinstance(m, TorchMultiheadAttention):
                limit = math.sqrt(6.0 / (4 * m.dim))
                uniform(m.in_proj_weight, -limit, limit)
                m.in_proj_bias.zero_()
            elif isinstance(m, DinoViT):
                if m.cfg.use_cls_token:
                    normal(m.cls_token, 0.02)
                normal(m.pos_embed, 0.02)
            elif isinstance(m, SigLIPTextEncoder):
                normal(m.token_embedding.weight, 0.02)
                normal(m.positional_embedding, 0.01)
            elif isinstance(m, TextAttention):  # a Dense kernel in JAX: lecun normal
                normal(m.in_proj_weight, m.in_proj_weight.shape[1] ** -0.5)
                m.in_proj_bias.zero_()
            elif isinstance(m, VisualEncoder):
                for name, p in m.named_parameters(recurse=False):
                    p.copy_(0.1 * torch.rand(p.shape, generator=g))
            elif isinstance(m, PolicyTower):
                uniform(m.last_actions_embed.weight, -0.01, 0.01)
                if m.cfg.use_object_in_hand:
                    uniform(m.object_in_hand_embed.weight, -0.01, 0.01)
                orthogonal(m.actor.linear.weight, 0.01)
                for lin in m.critic.modules():
                    if isinstance(lin, nn.Linear):
                        orthogonal(lin.weight, 1.0)

    # -------------- frozen encoders --------------

    def encode_images(self, images: torch.Tensor) -> torch.Tensor:
        """images (N, H, W, 3) normalised float -> (N, 7, 12, Dv) f32."""
        return self.vit(images)

    def encode_text(self, tokens: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """tokens (B, L) -> (B, L, Dt) f32. Frozen; call once per episode."""
        return self.t5(tokens, mask)

    # -------------- towers --------------

    def act_step(
        self, state: PolicyState, dino_nav, dino_manip, prev_actions, not_reset, object_in_hand
    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, PolicyState]:
        """Single rollout step -> (logits, values, cost values, new state).

        Bookkeeping as the reference (allenact_dino_transformer.py:376-406):
        the shared cache slot wraps at max_steps; a stream's time_step
        restarts at 0 where not_reset == 0."""
        max_steps = self.cfg.max_steps
        time_step = torch.where(not_reset != 0, state.time_step, 0)
        pos = 0 if state.pos >= max_steps else state.pos
        logits, values = [], []
        for t, tower in enumerate(self.towers):
            lg, v = tower.step(
                dino_nav, dino_manip, state.text_hidden, state.text_mask,
                prev_actions, not_reset, object_in_hand, time_step,
                state.cache["k"][t], state.cache["v"][t], pos, max_steps,
            )
            logits.append(lg)
            values.append(v)
        new_state = dataclasses.replace(state, pos=pos + 1, time_step=time_step + 1)
        if self.num_towers >= 3:
            return logits[0], values[1], values[2], new_state
        return logits[0], values[0], values[0], new_state

    def forward_seq(
        self,
        dino_nav,  # (B, T, gh, gw, Dv)
        dino_manip,  # (B, T, gh, gw, Dv) or None
        text_hidden,  # (B, E, L, Dt) with text_idx, (B, T, L, Dt) or (B, L, Dt)
        text_mask,  # the matching (..., L) bool
        prev_actions,  # (B, T) int
        not_reset,  # (B, T); 0 marks episode starts
        object_in_hand,  # (B, T) int or None
        time_step,  # (B, T) int in-episode step index
        traj_idx,  # (B, T) int trajectory ids (packed block-causal mask)
        text_idx=None,  # (B, T) int into the episode table
    ) -> PolicyOutputs:
        """Update-time full-sequence forward with trajectory-packed masking.

        Per tower, the fusion encoder runs over the packed B*T samples in
        chunks of cfg.fusion_chunk (the largest divisor of B*T not above it),
        as one autograd Function (`models/fusion_pass.py`): its activations
        are recomputed in the backward instead of stored, and on the card
        each pass is replayed from a CUDA graph once its shapes have been
        seen. The decoder runs full-sequence."""
        attn_mask = packed_block_causal_mask(traj_idx)
        b, t = dino_nav.shape[:2]
        n = b * t
        flat = lambda x: None if x is None else x.reshape((n,) + x.shape[2:])
        args = (flat(dino_nav), flat(dino_manip), *_flat_text(text_hidden, text_mask, text_idx, b, t))
        chunk = min(self.cfg.fusion_chunk or n, n)
        while n % chunk:
            chunk -= 1
        outs = []
        for tower in self.towers:
            obs_embeds = fusion_pass(tower, chunk, *args).reshape(b, t, -1)
            outs.append(
                tower.decode_heads(
                    obs_embeds, prev_actions, not_reset, object_in_hand, time_step, attn_mask
                )
            )
        logits, values, value_logits, sg = zip(*outs)
        return self._package_outputs(logits, values, value_logits, sg)

    # -------------- chunk-granular update decomposition --------------
    # The async pipeline runs the PPO epoch as many small programs woven
    # between the rollout's acts (algo/learner.py iter_chunked_update): the
    # same math as forward_seq, the fusion over a range of time steps of all
    # B streams, and the decoder and heads over the gathered embeddings.

    def _chunk_text(self, text_hidden, text_mask, text_idx, b: int, start_t: int, chunk_t: int):
        """Per-step instruction encodings of the time steps [start_t,
        start_t + chunk_t) of every stream, flattened b-major to
        (B*chunk_t, L, D), from forward_seq's three layouts; only the range
        is gathered."""
        n = b * chunk_t
        if text_idx is not None:
            rows = torch.arange(b, device=text_idx.device)[:, None]
            idx = text_idx[:, start_t : start_t + chunk_t].long()
            return (
                text_hidden[rows, idx].reshape((n,) + text_hidden.shape[2:]),
                text_mask[rows, idx].reshape(n, -1),
            )
        if text_hidden.dim() == 4:
            sl = lambda x: x[:, start_t : start_t + chunk_t]
            return sl(text_hidden).reshape((n,) + text_hidden.shape[2:]), sl(text_mask).reshape(n, -1)
        # per-stream (B, L, D): each stream's encoding serves its chunk_t rows
        return text_hidden.repeat_interleave(chunk_t, dim=0), text_mask.repeat_interleave(chunk_t, dim=0)

    def embed_time_range(
        self, dino_nav, dino_manip, text_hidden, text_mask, text_idx, start_t: int, chunk_t: int
    ) -> torch.Tensor:
        """Fusion embeddings of the time steps [start_t, start_t + chunk_t)
        of every stream -> (towers, B, chunk_t, D) f32 (the towers one after
        another; JAX vmaps them). `start_t` is a host int. Chunking along T,
        not the flat B*T index, keeps the batch axis whole in every chunk."""
        b = dino_nav.shape[0]
        n = b * chunk_t
        sl = lambda x: None if x is None else x[:, start_t : start_t + chunk_t].reshape((n,) + x.shape[2:])
        dn, dm = sl(dino_nav), sl(dino_manip)
        th, tm = self._chunk_text(text_hidden, text_mask, text_idx, b, start_t, chunk_t)
        return torch.stack([tower.embed_obs(dn, dm, th, tm).reshape(b, chunk_t, -1) for tower in self.towers])

    def decode_from_embeds(
        self, obs_embeds, prev_actions, not_reset, object_in_hand, time_step, traj_idx
    ) -> PolicyOutputs:
        """Decoder + heads over a buffer of fusion embeddings, obs_embeds
        (towers, B, T, D) f32 (the output of embed_time_range calls), with
        the packed block-causal mask of traj_idx."""
        attn_mask = packed_block_causal_mask(traj_idx)
        outs = [
            tower.decode_heads(emb, prev_actions, not_reset, object_in_hand, time_step, attn_mask)
            for tower, emb in zip(self.towers, obs_embeds)
        ]
        logits, values, value_logits, sg = zip(*outs)
        return self._package_outputs(logits, values, value_logits, sg)

    def acting_copy(self) -> "SafeVLAPolicy":
        """A policy for the async pipeline's rollout: a deep copy of the
        towers (their own tensors, no gradient), the frozen ViT and T5
        modules shared with this one. JAX acts with an immutable pytree of
        parameters; here the learner steps its towers in place while the
        rollout acts, so the rollout needs its own. `load_towers` refreshes
        them."""
        clone = copy.copy(self)
        clone._modules = type(self._modules)(self._modules)
        clone._parameters = type(self._parameters)(self._parameters)
        clone._buffers = type(self._buffers)(self._buffers)
        clone.towers = copy.deepcopy(self.towers).requires_grad_(False)
        return clone

    @torch.no_grad()
    def load_towers(self, source: "SafeVLAPolicy") -> None:
        """Copy source's tower weights into this policy's towers, in place,
        on the current stream."""
        for dst, src in zip(self.towers.parameters(), source.towers.parameters()):
            dst.copy_(src)

    def _package_outputs(self, logits, values, value_logits, sg) -> PolicyOutputs:
        """Per-tower head outputs -> PolicyOutputs (actor from tower 0; with
        three towers the critics from towers 1 and 2)."""
        critic, c_critic = (1, 2) if self.num_towers >= 3 else (0, None)
        return PolicyOutputs(
            logits=logits[0],
            values=values[critic],
            c_values=None if c_critic is None else values[c_critic],
            value_logits=value_logits[critic],
            c_value_logits=None if c_critic is None else value_logits[c_critic],
            stop_grad_values=sg[critic],
            extras={},
        )

    # -------------- state management --------------

    def init_state(self, num_samplers: int, text_len: Optional[int] = None) -> PolicyState:
        c = self.cfg
        text_len = text_len or c.text_max_tokens
        dcfg = self.towers[0].decoder_config()
        # one zeroed (L, B, S, H, Dh) cache per tower, S = the (possibly
        # raised) max_steps
        shape = (self.num_towers, dcfg.n_layers, num_samplers, c.max_steps, dcfg.n_heads, dcfg.head_dim)
        cache = {k: torch.zeros(shape, dtype=dcfg.dtype, device=self.device) for k in ("k", "v")}
        return PolicyState(
            cache=cache,
            pos=0,
            time_step=torch.zeros(num_samplers, dtype=torch.int32, device=self.device),
            text_hidden=torch.zeros(num_samplers, text_len, c.text_embed_size, device=self.device),
            text_mask=torch.zeros(num_samplers, text_len, dtype=torch.bool, device=self.device),
        )

    def update_text(self, state: PolicyState, sampler_idx, text_hidden, text_mask) -> PolicyState:
        """Install a fresh episode's instruction encoding for given samplers."""
        th = state.text_hidden.clone()
        tm = state.text_mask.clone()
        th[sampler_idx] = text_hidden
        tm[sampler_idx] = text_mask
        return dataclasses.replace(state, text_hidden=th, text_mask=tm)
