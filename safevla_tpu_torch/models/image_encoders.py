"""Image-encoder registry: backbone name -> frozen encoder module.

Counterpart of `safevla_tpu/models/image_encoders.py`, ViT backbones only:
every encoder takes (B, H, W, 3) normalised float and returns
(B, 7, 12, feature_dim) f32. The CLIP ResNet-50 is not ported yet.
"""

from __future__ import annotations

from safevla_tpu_torch.models.vit import VIT_CONFIGS, DinoViT

# reference registry names -> this framework's backbone keys
REFERENCE_ENCODER_ALIASES = {
    "Dinov2Small": "dinov2_vits14",
    "Dinov2Base": "dinov2_vitb14",
    "SigLIPBase": "siglip_vitb16_256",
}


def build_image_encoder(name: str) -> DinoViT:
    name = REFERENCE_ENCODER_ALIASES.get(name, name)
    if name in VIT_CONFIGS:
        return DinoViT(VIT_CONFIGS[name])
    raise KeyError(f"unknown or unported vision backbone {name!r}; known: {sorted(VIT_CONFIGS)}")
