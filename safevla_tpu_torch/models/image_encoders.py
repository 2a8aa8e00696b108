"""Image-encoder registry: backbone name -> frozen encoder module.

Counterpart of `safevla_tpu/models/image_encoders.py`: every encoder takes
(B, H, W, 3) normalised float and returns (B, 7, 12, feature_dim) f32, with
a `pool_grid` attribute, so the policy towers never see which backbone made
the grid.
"""

from __future__ import annotations

from torch import nn

from safevla_tpu_torch.models.resnet import RESNET_CONFIGS, ClipResNet
from safevla_tpu_torch.models.vit import VIT_CONFIGS, DinoViT

# reference registry names -> this framework's backbone keys
REFERENCE_ENCODER_ALIASES = {
    "Dinov2Small": "dinov2_vits14",
    "Dinov2Base": "dinov2_vitb14",
    "ClipResNet50": "clip_rn50",
    "SigLIPBase": "siglip_vitb16_256",
}


def build_image_encoder(name: str) -> nn.Module:
    name = REFERENCE_ENCODER_ALIASES.get(name, name)
    if name in VIT_CONFIGS:
        return DinoViT(VIT_CONFIGS[name])
    if name in RESNET_CONFIGS:
        return ClipResNet(RESNET_CONFIGS[name])
    raise KeyError(f"unknown vision backbone {name!r}; known: {sorted(VIT_CONFIGS) + sorted(RESNET_CONFIGS)}")


def encoder_feature_dim(name: str) -> int:
    name = REFERENCE_ENCODER_ALIASES.get(name, name)
    if name in VIT_CONFIGS:
        return VIT_CONFIGS[name].embed_dim
    if name in RESNET_CONFIGS:
        return RESNET_CONFIGS[name].out_dim
    raise KeyError(name)
