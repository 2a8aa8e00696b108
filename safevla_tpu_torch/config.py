"""Configuration dataclasses read by the serving path.

Copy of the fields of `safevla_tpu/config.py::ModelConfig` and of the two
`TrainConfig` fields the inference agent reads (`max_steps`,
`augmentation_version`), with identical defaults. The rest of the JAX config
tree (PPO, Lagrange, offline, mesh, eval) is ported with the slices that
read it.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Tuple

from safevla_tpu_torch.constants import NUM_ACTIONS


@dataclass
class ModelConfig:
    """Policy architecture (reference: dinov2_vits_tsfm_base.py:234-270)."""

    num_actions: int = NUM_ACTIONS
    hidden_size: int = 512
    num_tx_layers: int = 3
    num_tx_heads: int = 8
    goal_dims: int = 512
    text_embed_size: int = 512

    # frozen vision encoder
    vision_backbone: str = "dinov2_vits14"  # 384-dim ViT-S/14
    vision_feature_dim: int = 384
    vision_grid: Tuple[int, int] = (7, 12)  # adaptive-pooled patch grid
    image_size: Tuple[int, int] = (224, 384)  # H, W after crop

    # frozen text encoder
    text_backbone: str = "t5-small"
    text_max_tokens: int = 32

    # fusion transformer (torch nn.TransformerEncoder semantics: post-LN, ReLU)
    combiner_layers: int = 3
    combiner_heads: int = 8
    combiner_ffn_dim: int = 2048

    # decoder
    dino_compressor_hidden_out_dims: Tuple[int, int] = (512, 512)
    max_steps: int = 500  # decoder max_seq_len == max episode steps
    add_prev_actions: bool = True
    add_prev_action_null_token: bool = True
    use_manipulation_camera: bool = True
    use_object_in_hand: bool = True
    critic_type: str = "linear"  # linear (mlp | discrete: not ported yet)
    hl_gauss_min: float = -5.0
    hl_gauss_max: float = 15.0
    hl_gauss_bins: int = 101
    hl_gauss_sigma: float = 0.15

    traj_max_idx: int = 2048
    use_traj_indexing: bool = True

    fusion_chunk: int = 128
    async_fusion_chunk: Optional[int] = 64

    # 1 = shared actor/critic tower, 3 = actor / reward critic / cost critic
    num_towers: int = 3

    # compute dtype of the towers (frozen weights are stored in it)
    compute_dtype: str = "bfloat16"


@dataclass
class TrainConfig:
    """The fields of the online run configuration the serving path reads."""

    max_steps: int = 500  # per-episode cap; augmentation resamples this often
    augmentation_version: str = "v2"


@dataclass
class Config:
    model: ModelConfig = field(default_factory=ModelConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
