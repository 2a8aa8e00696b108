"""Configuration dataclasses read by the serving path, the learner update,
the rollout runner, the online trainers, the evaluator and the offline
(behaviour cloning) trainer.

Copies of `safevla_tpu/config.py::ModelConfig`, `PPOConfig`,
`LagrangeConfig`, `TrainingStageConfig`, `TrainConfig`, `OfflineConfig`,
`MeshConfig`, `EvalConfig` and `Config` (its data roots included), with
identical defaults, and of `apply_overrides` (with its presets).
"""

from __future__ import annotations

import difflib
import json
import os
from dataclasses import dataclass, field
from typing import Any, List, Optional, Tuple

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
    critic_type: str = "linear"  # linear | mlp | discrete
    # HL-Gauss discrete critic (reference allenact_dino_transformer.py:152-158)
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

    # compute dtype of the forward. The trainable tower parameters stay f32
    # and are cast to it at use (flax Dense); the frozen ViT and T5 store
    # their linear weights in it (one rounding at load, the same cast)
    compute_dtype: str = "bfloat16"


@dataclass
class PPOConfig:
    """Constrained-PPO hyperparams (reference: dinov2_vits_tsfm_base.py:314-347)."""

    clip_param: float = 0.1
    value_loss_coef: float = 0.5
    entropy_coef: float = 0.0
    use_clipped_value_loss: bool = False
    normalize_advantage: bool = False
    gamma: float = 0.99
    gae_lambda: float = 0.95
    max_grad_norm: float = 0.5
    lr: float = 2e-5
    num_mini_batch: int = 1
    update_repeats: int = 4
    num_steps: int = 128  # rollout length per iteration


@dataclass
class LagrangeConfig:
    """Lagrange multiplier schedule (omnisafe.common.lagrange semantics)."""

    cost_limit: float = 2.31
    multiplier_init: float = 0.001
    multiplier_lr: float = 0.035
    multiplier_upper_bound: Optional[float] = None


@dataclass
class TrainingStageConfig:
    """One pipeline stage: named losses + weights (AllenAct PipelineStage
    semantics, reference dinov2_vits_tsfm_base.py:332-379). Names:
    ppo_log_loss (PPO-Lagrangian surrogate incl. value/cost-value at
    value_loss_coef), ppo_loss (unconstrained variant), ppo_value_loss,
    safe_ppo_value_loss, imitation_bce_loss."""

    loss_names: List[str] = field(default_factory=list)
    max_stage_steps: int = 0
    loss_weights: Optional[List[float]] = None  # None -> 1.0 each


@dataclass
class TrainConfig:
    """Online safe-RL run configuration."""

    task_type: str = "ObjectNavType"
    tag: str = "SafeVLA-TPU-ObjectNavType"
    num_train_processes: int = 32
    max_steps: int = 500  # per-episode cap; augmentation resamples this often
    steps_in_house_before_force_scene_advance: int = 2000
    save_interval: int = 50_000
    metric_accumulate_interval: int = 1_000
    output_dir: str = "output"
    seed: int = 123
    il_ckpt_path: Optional[str] = None
    resume_ckpt_path: Optional[str] = None
    total_steps: int = 1_000_000_000
    # 3-stage pipeline (reference dinov2_vits_tsfm_base.py:310-379): stage 0
    # trains only the critics, stages 1-2 the full PPO-Lagrangian loss
    stages: List[TrainingStageConfig] = field(
        default_factory=lambda: [
            TrainingStageConfig(["ppo_value_loss", "safe_ppo_value_loss"], 200_000),
            TrainingStageConfig(["ppo_log_loss"], 800_000),
            TrainingStageConfig(["ppo_log_loss"], int(1e9) - 1_000_000),
        ]
    )
    use_data_augmentation: bool = True
    # torchvision transform list version (reference transformation_util.py:12)
    augmentation_version: str = "v2"
    collision_penalty: float = 0.0
    # Default training mode: the async rollout/update pipeline (the PPO
    # epoch decomposed into chunk programs pumped between the rollout's env
    # steps on a CUDA stream of their own, learner.iter_chunked_update).
    # Stale-by-one-window PPO. Set False for strictly on-policy synchronous
    # updates.
    async_pipeline: bool = True


@dataclass
class OfflineConfig:
    """Offline IL (behavior cloning) configuration (reference train_pl.py:24-71)."""

    lr: float = 1e-4
    per_device_batch_size: int = 16
    sliding_window: int = 50
    max_samples: int = 10_000_000
    eval_max_samples: int = 2_000
    num_epochs: int = 100
    precision: str = "bfloat16"
    dataset_version: str = "CHORES"
    data_dir: str = "data"
    loader_workers: int = 4
    # host-side batch prep (hdf5/mp4 decode + tokenize + pinned host copy)
    # runs in a background thread this many batches ahead of the device
    # step, so IO overlaps compute. 0 disables the thread (synchronous prep).
    prefetch_batches: int = 2
    prob_sample_last_steps: float = 0.0
    # on resume, load model weights but re-initialize the optimizer state
    # (reference AdamWSkipLoadStateDict + --restart_optimizer, train_pl.py:74-80)
    restart_optimizer: bool = False


@dataclass
class MeshConfig:
    """Device mesh layout. dp shards the sampler/batch axis over the ranks
    (`parallel/mesh.py`: one process per GPU on torch.distributed)."""

    dp: int = -1  # -1: use all ranks
    mdl: int = 1  # model axis kept for future TP; size 1 for this policy scale


@dataclass
class EvalConfig:
    num_workers: int = 8
    seed: int = 123
    benchmark_subset: str = "minival"
    gt_detection: bool = True
    max_eval_tasks: Optional[int] = None
    test_augmentation: bool = True
    save_videos: bool = False


@dataclass
class Config:
    model: ModelConfig = field(default_factory=ModelConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    ppo: PPOConfig = field(default_factory=PPOConfig)
    lagrange: LagrangeConfig = field(default_factory=LagrangeConfig)
    offline: OfflineConfig = field(default_factory=OfflineConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)
    eval: EvalConfig = field(default_factory=EvalConfig)

    # data roots (env-var fallbacks mirror the reference's
    # utils/constants/objaverse_data_dirs.py)
    objaverse_houses_dir: str = field(
        default_factory=lambda: os.environ.get("OBJAVERSE_HOUSES_DIR", "")
    )
    objaverse_data_dir: str = field(
        default_factory=lambda: os.environ.get("OBJAVERSE_DATA_DIR", "")
    )


def _parse_value(raw: str, current: Any) -> Any:
    if isinstance(current, bool):
        return raw.lower() in ("1", "true", "yes", "on")
    if isinstance(current, int) and not isinstance(current, bool):
        return int(float(raw))
    if isinstance(current, float):
        return float(raw)
    if isinstance(current, (list, tuple)):
        val = json.loads(raw)
        return type(current)(val) if isinstance(current, tuple) else val
    if current is None:
        # Optional fields carry no type witness: infer from the literal
        low = raw.lower()
        if low in ("none", "null"):
            return None
        if low in ("true", "false"):
            return low == "true"
        for cast in (int, float):
            try:
                return cast(raw)
            except ValueError:
                pass
        try:
            return json.loads(raw)
        except ValueError:
            return raw
    if raw.lower() in ("none", "null"):
        return None
    return raw


# Named experiment presets, selected with `preset=<name>` on any CLI;
# explicit overrides still win.
PRESETS = {
    "dinov2_t5": [],  # the defaults
    "siglip_base": [
        "model.vision_backbone=siglip_vitb16_256",
        "model.vision_feature_dim=768",
        "model.image_size=[256, 256]",
        "model.text_backbone=siglip_base",
        "model.text_embed_size=768",
        "model.text_max_tokens=64",
    ],
}


def apply_overrides(cfg: Config, overrides: List[str]) -> Config:
    """Apply CLI overrides of the form section.field=value or field=value.
    `preset=<name>` expands to its override list first (later explicit
    overrides win)."""
    expanded: List[str] = []
    rest: List[str] = []
    for ov in overrides:
        key = ov.lstrip("-").split("=", 1)[0]
        if key == "preset":
            name = ov.split("=", 1)[1]
            if name not in PRESETS:
                raise ValueError(f"Unknown preset {name!r}; available: {sorted(PRESETS)}")
            expanded += PRESETS[name]
        else:
            rest.append(ov)
    for ov in expanded + rest:
        ov = ov.lstrip("-")
        if "=" not in ov:
            raise ValueError(f"Override must be key=value, got: {ov}")
        key, raw = ov.split("=", 1)
        parts = key.split(".")
        obj = cfg
        for p in parts[:-1]:
            obj = getattr(obj, p)
        leaf = parts[-1]
        if not hasattr(obj, leaf):
            candidates = []
            for sec_name, sec in vars(cfg).items():
                if hasattr(sec, "__dataclass_fields__"):
                    candidates += [f"{sec_name}.{f}" for f in vars(sec)]
                else:
                    candidates.append(sec_name)
            hint = difflib.get_close_matches(key, candidates, n=3, cutoff=0.5)
            suffix = f" (did you mean: {', '.join(hint)}?)" if hint else ""
            raise AttributeError(f"Unknown config key: {key}{suffix}")
        setattr(obj, leaf, _parse_value(raw, getattr(obj, leaf)))
    return cfg
