"""Analytic FLOP accounting for the PPO update and the offline BC step
(the share of the card's peak that chip_smoke.py reports).

The port's copy of `safevla_tpu/algo/flops.py`, over the port's own
encoder registries: `models/vit.py::VIT_CONFIGS` and, beyond JAX's copy,
`models/resnet.py::RESNET_CONFIGS`, and no CLS token for a patch-only ViT.
Counts multiply-accumulates x2 for the policy at the production shapes. The fusion encoder is rematerialized
(each chunk recomputed in the backward, `models/fusion_pass.py`), so its
forward runs TWICE on the backward pass: epoch cost ~ 4 x fusion_fwd + 3 x decoder_fwd per tower. Heads/GAE/optimizer are noise at
these scales and are ignored.
"""

from __future__ import annotations


def _fusion_fwd_flops(cfg, n_samples: int) -> float:
    m = cfg.model
    gh, gw = m.vision_grid
    cams = 2 if m.use_manipulation_camera else 1
    d = m.hidden_size
    ffn = m.combiner_ffn_dim
    L = m.text_max_tokens
    n_tok = 1 + cams * gh * gw + L

    per_layer = n_tok * (8 * d * d + 4 * d * ffn) + 4 * n_tok * n_tok * d
    # last layer computes q/out-proj/MLP only for the consumed CLS row
    # (fusion.py out_rows=1): keeps the k/v projection (2/8 of the qkv+out
    # matmuls) over all tokens plus one row's worth of everything else
    last_layer = (
        n_tok * 2 * d * d  # k/v projection
        + 1 * (6 * d * d + 4 * d * ffn)  # q, out-proj, MLP for the CLS row
        + 4 * n_tok * d  # single-query attention
    )
    h0, h1 = m.dino_compressor_hidden_out_dims
    compressor = cams * gh * gw * 2 * (m.vision_feature_dim * h0 + h0 * h1)
    adapters = cams * gh * gw * 2 * h1 * h1 + L * 2 * m.text_embed_size * m.goal_dims
    return n_samples * (
        (m.combiner_layers - 1) * per_layer + last_layer + compressor + adapters
    )


def _decoder_fwd_flops(cfg, batch: int, seq: int) -> float:
    m = cfg.model
    d = m.hidden_size
    # SwiGLU hidden (llama sizing: 2/3 * 4d rounded up to multiple of 256)
    hidden = int(2 * (4 * d) / 3)
    hidden = 256 * ((hidden + 255) // 256)
    per_token = 8 * d * d + 6 * d * hidden + 2 * seq * d  # causal attn ~seq/2*4
    return batch * seq * (m.num_tx_layers * per_token + 2 * d * d)  # + output proj


def update_flops_estimate(cfg, batch: int, seq: int) -> float:
    """Total FLOPs of one `Learner.update` (update_repeats epochs)."""
    n = batch * seq
    fus = _fusion_fwd_flops(cfg, n)
    dec = _decoder_fwd_flops(cfg, batch, seq)
    towers = cfg.model.num_towers
    per_epoch = towers * (4 * fus + 3 * dec)
    return cfg.ppo.update_repeats * per_epoch


def _resnet_fwd_flops(rc, h: int, w: int) -> float:
    """CLIP's ResNet forward on one h x w frame: 2 x the multiply-accumulates
    of every convolution (the stem's three 3x3, each bottleneck's 1x1, 3x3,
    1x1 and its shortcut's 1x1); pools and BatchNorm are noise."""
    conv = lambda hw, cin, cout, k: 2.0 * hw[0] * hw[1] * cin * cout * k * k
    hw = (-(-h // 2), -(-w // 2))  # the stride-2 stem conv
    wd = rc.width
    total = conv(hw, 3, wd // 2, 3) + conv(hw, wd // 2, wd // 2, 3) + conv(hw, wd // 2, wd, 3)
    hw = (hw[0] // 2, hw[1] // 2)  # the stem's average pool
    inplanes = wd
    for stage, blocks in enumerate(rc.layers):
        planes = wd * 2**stage
        for i in range(blocks):
            stride = 2 if (stage > 0 and i == 0) else 1
            out = (hw[0] // stride, hw[1] // stride)
            total += conv(hw, inplanes, planes, 1) + conv(hw, planes, planes, 3) + conv(out, planes, 4 * planes, 1)
            if stride > 1 or inplanes != 4 * planes:
                total += conv(out, inplanes, 4 * planes, 1)
            hw, inplanes = out, 4 * planes
    return total


def _vit_fwd_flops(cfg, frames: int) -> float:
    """Frozen image encoder forward over `frames` camera frames: a ViT's
    matmuls + attention + patch embed, or a ResNet's convolutions. Needed
    because the compiled-step cost analysis can't be trusted for this (see
    bc_step_flops_estimate)."""
    from safevla_tpu_torch.models.image_encoders import REFERENCE_ENCODER_ALIASES
    from safevla_tpu_torch.models.resnet import RESNET_CONFIGS
    from safevla_tpu_torch.models.vit import VIT_CONFIGS

    name = REFERENCE_ENCODER_ALIASES.get(cfg.model.vision_backbone, cfg.model.vision_backbone)
    if name in RESNET_CONFIGS:
        return frames * _resnet_fwd_flops(RESNET_CONFIGS[name], *cfg.model.image_size)
    vc = VIT_CONFIGS[name]
    gh, gw = vc.img_height // vc.patch_size, vc.img_width // vc.patch_size
    n_tok = int(vc.use_cls_token) + gh * gw
    d = vc.embed_dim
    ffn = int(vc.mlp_ratio * d)
    per_tok_layer = 2 * d * (3 * d) + 2 * d * d + 2 * d * ffn * 2  # qkv+proj+mlp
    matmul = frames * vc.depth * n_tok * per_tok_layer
    attn = frames * vc.depth * 4 * n_tok * n_tok * d
    patch = frames * gh * gw * 2 * (3 * vc.patch_size**2) * d
    return matmul + attn + patch


def bc_step_flops_estimate(cfg, batch: int, seq: int) -> float:
    """Total FLOPs of one offline BC step: frozen ViT forward over both
    cameras + tower fwd/remat/bwd (same 4xfusion + 3xdecoder convention as
    the update, one epoch). The port's fusion chunks are recomputed
    in the backward (`models/fusion_pass.py`), so their forward runs twice
    too."""
    cams = 2 if cfg.model.use_manipulation_camera else 1
    n = batch * seq
    vit = _vit_fwd_flops(cfg, cams * n)
    fus = _fusion_fwd_flops(cfg, n)
    dec = _decoder_fwd_flops(cfg, batch, seq)
    return vit + cfg.model.num_towers * (4 * fus + 3 * dec)
