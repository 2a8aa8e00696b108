"""SafeVLA policy: DINOv2 features -> fusion transformer -> causal decoder
-> actor / reward-critic / cost-critic.

Counterpart of `safevla_tpu/models/actor_critic.py`, serving path only
(`act_step`, `init_state`, `update_text`; the update's `forward_seq` comes
with the training slice). Three `PolicyTower` modules run one after another
(the JAX package vmaps one tower over stacked parameters); logits come from
tower 0, values from tower 1, cost values from tower 2. Tower modules carry
the reference's torch state-dict names (`visual_encoder.fusion_xformer...`,
`last_actions_embed`, `decoder.layers.N...`, `actor.linear`, `critic.fc`);
the reference prefixes its critic towers with `critic_tsfm.` and
`c_critic_tsfm.`, which are `towers.1.` and `towers.2.` here.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from safevla_tpu_torch import resolve_device
from safevla_tpu_torch.config import ModelConfig
from safevla_tpu_torch.models.fusion import FusionTransformer, TorchMultiheadAttention
from safevla_tpu_torch.models.image_encoders import build_image_encoder
from safevla_tpu_torch.models.llama_decoder import DecoderConfig, LlamaDecoder, RMSNorm
from safevla_tpu_torch.models.norms import CompatLayerNorm
from safevla_tpu_torch.models.t5 import T5Config, T5Encoder, T5LayerNorm
from safevla_tpu_torch.models.vit import DinoViT, LayerScale
from safevla_tpu_torch.ops.masks import incremental_episode_mask


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
            nn.Conv2d(c.vision_feature_dim, h0, 1, dtype=dtype), nn.ReLU(),
            nn.Conv2d(h0, h1, 1, dtype=dtype), nn.ReLU(),
        )
        # reference adapter order: Linear, LayerNorm (f32, eps 1e-6), ReLU
        self.visual_adapter = nn.Sequential(
            nn.Linear(h1, h1, dtype=dtype), CompatLayerNorm(h1), nn.ReLU()
        )
        self.text_adapter = nn.Sequential(
            nn.Linear(c.text_embed_size, c.goal_dims, dtype=dtype),
            CompatLayerNorm(c.goal_dims),
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
        conv0, conv1 = self.visual_compressor[0], self.visual_compressor[2]
        x = F.relu(F.linear(feat.to(self.dtype), conv0.weight.flatten(1), conv0.bias))
        x = F.relu(F.linear(x, conv1.weight.flatten(1), conv1.bias))
        x = x.reshape(feat.shape[0], -1, x.shape[-1])
        x = self.visual_adapter(x).to(self.dtype)
        return x + cam_token.to(self.dtype)


class ActorHead(nn.Module):
    def __init__(self, dim: int, num_actions: int):
        super().__init__()
        self.linear = nn.Linear(dim, num_actions)  # f32


class CriticHead(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.fc = nn.Linear(dim, 1)  # f32


class PolicyTower(nn.Module):
    """One trainable tower: compressor + fusion + decoder + heads. Frozen
    encoder outputs come in as tensors."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        if cfg.critic_type != "linear":
            raise NotImplementedError(
                f"critic_type={cfg.critic_type!r} is not ported yet (only 'linear')"
            )
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
        self.critic = CriticHead(d)

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

    def _heads(self, beliefs):
        logits = self.actor.linear(beliefs)
        values = self.critic.fc(beliefs)[..., 0]
        return logits, values

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
        logits, values = self._heads(beliefs)
        return logits[:, 0], values[:, 0]


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
        if "siglip" in cfg.text_backbone.lower():
            raise NotImplementedError("the SigLIP text tower is not ported yet")
        self.t5 = T5Encoder(T5Config(d_model=cfg.text_embed_size))
        self.towers = nn.ModuleList(PolicyTower(cfg) for _ in range(cfg.num_towers))
        self.num_towers = cfg.num_towers
        self.init_params(generator or torch.Generator().manual_seed(0))
        self.to(device)

    @property
    def device(self) -> torch.device:
        return self.vit.pos_embed.device

    @torch.no_grad()
    def init_params(self, generator: torch.Generator) -> None:
        """Random weights from `generator`, with the JAX package's init
        families (lecun-normal dense kernels, zero biases, unit norms,
        xavier in_proj, orthogonal heads, small uniform embeddings)."""
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
            elif isinstance(m, VisualEncoder):
                for name, p in m.named_parameters(recurse=False):
                    p.copy_(0.1 * torch.rand(p.shape, generator=g))
            elif isinstance(m, PolicyTower):
                uniform(m.last_actions_embed.weight, -0.01, 0.01)
                if m.cfg.use_object_in_hand:
                    uniform(m.object_in_hand_embed.weight, -0.01, 0.01)
                orthogonal(m.actor.linear.weight, 0.01)
                orthogonal(m.critic.fc.weight, 1.0)

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
