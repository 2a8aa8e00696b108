"""What the benchmark takes from the program: its Config with a configuration
file's overrides applied, and the check that the file states the sizes the
program runs."""

from __future__ import annotations

import dataclasses

# configuration-file key -> the program's ModelConfig field
MODEL_FIELDS = {
    "num_actions": "num_actions",
    "hidden_size": "hidden_size",
    "goal_dims": "goal_dims",
    "vision_feature_dim": "vision_feature_dim",
    "vision_grid": "vision_grid",
    "text_embed_size": "text_embed_size",
    "text_max_tokens": "text_max_tokens",
    "compressor_dims": "dino_compressor_hidden_out_dims",
    "fusion_layers": "combiner_layers",
    "fusion_heads": "combiner_heads",
    "fusion_ffn_dim": "combiner_ffn_dim",
    "decoder_layers": "num_tx_layers",
    "decoder_heads": "num_tx_heads",
    "max_steps": "max_steps",
    "critic_type": "critic_type",
    "compute_dtype": "compute_dtype",
}


def program_config(config: dict, towers: int):
    """The program's Config for a configuration file, with `towers` towers."""
    from safevla_tpu_torch.config import Config, apply_overrides

    cfg = apply_overrides(Config(), list(config["overrides"]))
    cfg.model = dataclasses.replace(cfg.model, num_towers=towers)
    m = config["model"]
    for key, field in MODEL_FIELDS.items():
        got = getattr(cfg.model, field)
        got = list(got) if isinstance(got, tuple) else got
        if got != m[key]:
            raise ValueError(f"the configuration file states {key}={m[key]!r}; the program runs {got!r}")
    if cfg.model.vision_backbone != config["vision"]["name"]:
        raise ValueError(f"vision backbone {cfg.model.vision_backbone!r} != {config['vision']['name']!r}")
    return cfg


def strict_load(module, weights: dict) -> None:
    """Load a state dict whose names, shapes and dtypes must all be the module's."""
    own = module.state_dict()
    for k, v in weights.items():
        if k in own and own[k].dtype != v.dtype:
            raise ValueError(f"{k}: the program stores {own[k].dtype}, the benchmark made {v.dtype}")
    module.load_state_dict(weights, strict=True)
