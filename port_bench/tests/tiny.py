"""Tiny cells for rehearsing the benchmark on the CPU: the real cells'
traffic kinds, drivers, checks and metrics at small widths, with a tiny
ViT registered in the program's registry as the repository's tests do."""

from __future__ import annotations

import copy

from port_bench import harness

TINY_VIT = {"name": "port_bench_tiny_siglip", "patch_size": 8, "embed_dim": 16, "depth": 2, "num_heads": 2,
            "mlp_ratio": 4.0, "image_size": [32, 32], "cls_token": False, "tokens_padded": 16,
            "dtype": "float32"}
TINY_TEXT = {"name": "siglip_base", "vocab_size": 32000, "d_model": 32, "num_layers": 12, "num_heads": 8,
             "mlp_ratio": 4.0, "max_tokens": 8}
TINY_MODEL = {"hidden_size": 32, "goal_dims": 32, "vision_feature_dim": 16, "text_embed_size": 32,
              "text_max_tokens": 8, "compressor_dims": [32, 32], "fusion_layers": 2, "fusion_heads": 2,
              "fusion_ffn_dim": 64, "decoder_layers": 2, "decoder_heads": 2, "compute_dtype": "float32"}
TINY_OVERRIDES = [
    "model.vision_backbone=port_bench_tiny_siglip", "model.image_size=[32, 32]", "model.hidden_size=32",
    "model.goal_dims=32", "model.vision_feature_dim=16", "model.text_embed_size=32", "model.text_max_tokens=8",
    "model.dino_compressor_hidden_out_dims=[32, 32]", "model.combiner_layers=2", "model.combiner_heads=2",
    "model.combiner_ffn_dim=64", "model.num_tx_layers=2", "model.num_tx_heads=2", "model.compute_dtype=float32",
]
# the tiny cells' own limits (f32 on both sides, bf16 only in the text tower)
TINY_LIMITS = {"loss.1": 1e-3, "loss.2": 1e-3, "grad": 0.05, "change": 0.05}


def register_vit() -> None:
    import torch

    from safevla_tpu_torch.models.vit import VIT_CONFIGS, DinoViTConfig

    v = TINY_VIT
    VIT_CONFIGS[v["name"]] = DinoViTConfig(
        patch_size=v["patch_size"], embed_dim=v["embed_dim"], depth=v["depth"], num_heads=v["num_heads"],
        img_height=v["image_size"][0], img_width=v["image_size"][1], layerscale=False, use_cls_token=False,
        dtype=torch.float32,
    )


def spec(cell: str) -> harness.Spec:
    """The named cell of BENCHMARK.json at tiny widths and a short traffic."""
    register_vit()
    s = harness.Spec(cell)
    cfg = copy.deepcopy(s.config)
    bc = s.traffic["driver"] == "bc"
    cfg["overrides"] = (["preset=siglip_base"] if bc else []) + TINY_OVERRIDES
    cfg["model"].update(TINY_MODEL)
    cfg["vision"] = dict(TINY_VIT)
    if bc:
        cfg["text"] = dict(TINY_TEXT)
    s.config = cfg
    tr = copy.deepcopy(s.traffic)
    if bc:
        tr.update(batch=4, window=6, valid_steps=[6, 6, 5, 3])
    else:
        tr.update(streams=4, steps=8)
    s.traffic = tr
    s.workload = dict(s.workload, limits=dict(TINY_LIMITS))
    return s
