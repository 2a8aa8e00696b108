"""Torch checkpoint readers: reference SafeVLA weights -> the port's modules.

The port's own copy of the torch-side readers of
`safevla_tpu/models/convert.py`. The reference publishes / loads three
container formats (SURVEY §3.5):
  * Lightning IL ckpt: {"state_dict": {"model.<k>": v}} (train_pl.py:289-302)
  * AllenAct RL ckpt:  {"model_state_dict": {<k>: v}} (allenact_trainer resume)
  * raw state dict:    {<k>: v}
with tower prefixes "" (actor), "critic_tsfm." (reward critic) and
"c_critic_tsfm." (cost critic) for the separate-critic model (reference
separate_actor_critic.py:8-37).

The port's modules carry the reference's torch state-dict names, so where
the JAX importers re-lay each tensor into a flax tree, loading here is by
name: every parameter of a port tower must be in the tower's dict with its
exact shape (keys the tower does not have are skipped, as the JAX importer
skips keys it does not read). A checkpoint without critic towers (a plain
IL checkpoint) fills them from the actor tower, as the reference loads the
IL policy into every tower at RL start.

The frozen encoders: `import_dinov2` takes a torch-hub DINOv2 state dict to
the port's ViT (its positional embedding interpolated once to the patch
grid, bicubic with antialias), `import_t5` an HF T5EncoderModel state dict
to the port's T5, `import_siglip_trunk` an open_clip / timm SigLIP ViT trunk
to the port's ViT (its 16x16 position grid as it is) and
`import_siglip_text` an open_clip SigLIP TextTransformer to the port's text
tower (`models/resnet.py::import_clip_resnet` takes CLIP's ResNet).
"""

from __future__ import annotations

from typing import Any, Dict, List, Mapping

import torch
import torch.nn.functional as F
from torch import nn

# tower roles in a separate-critic state dict, in the port's tower order
TOWER_PREFIXES = (("actor", ""), ("critic", "critic_tsfm."), ("c_critic", "c_critic_tsfm."))


def split_tower_state_dicts(flat_sd: Mapping[str, Any]) -> Dict[str, Dict[str, Any]]:
    """Split a separate-critic state dict into per-tower dicts keyed by role."""
    towers: Dict[str, Dict[str, Any]] = {"actor": {}, "critic": {}, "c_critic": {}}
    for k, v in flat_sd.items():
        if k.startswith("c_critic_tsfm."):
            towers["c_critic"][k[len("c_critic_tsfm.") :]] = v
        elif k.startswith("critic_tsfm."):
            towers["critic"][k[len("critic_tsfm.") :]] = v
        else:
            towers["actor"][k] = v
    return towers


def normalize_reference_checkpoint(ckpt: Mapping[str, Any]) -> Dict[str, Any]:
    """Unwrap the three reference container formats to a flat state dict."""
    if "model_state_dict" in ckpt:
        sd = ckpt["model_state_dict"]
    elif "state_dict" in ckpt:
        sd = {
            (k[len("model.") :] if k.startswith("model.") else k): v
            for k, v in ckpt["state_dict"].items()
        }
    else:
        sd = ckpt
    # IL checkpoints name the actor head "actor.weight/bias"
    # (reference train_utils.py remaps to actor.linear.*)
    out = {}
    for k, v in sd.items():
        if k.startswith("actor.") and not k.startswith("actor.linear."):
            k = "actor.linear." + k[len("actor.") :]
        out[k] = v
    return out


def select_state_dict(sd: Mapping[str, Any], want: Mapping[str, torch.Tensor], what: str) -> Dict[str, torch.Tensor]:
    """The entries of `sd` named in `want` (a module's state dict), each
    checked against its shape there; raises ValueError on a missing key or
    a shape that differs. Keys `want` does not name are skipped."""
    missing = sorted(k for k in want if k not in sd)
    if missing:
        raise ValueError(f"{what}: {len(missing)} parameters missing from the checkpoint, e.g. {missing[:5]}")
    out = {}
    for k, ref in want.items():
        t = torch.as_tensor(sd[k])
        if tuple(t.shape) != tuple(ref.shape):
            raise ValueError(f"{what}: {k} has shape {tuple(t.shape)}, the model {tuple(ref.shape)}")
        out[k] = t
    return out


def read_reference_checkpoint(path: str) -> Dict[str, Dict[str, Any]]:
    """A reference torch file (any of the three containers) -> its per-role
    tower state dicts; a missing critic tower is the actor's."""
    # Lightning checkpoints pickle more than tensors (hyper-parameters,
    # callbacks), so the whole file is unpickled, as the JAX importer does
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    towers = split_tower_state_dicts(normalize_reference_checkpoint(ckpt))
    for role in ("critic", "c_critic"):
        towers[role] = towers[role] or towers["actor"]
    return towers


@torch.no_grad()
def load_reference_towers(path: str, towers: nn.ModuleList) -> None:
    """Fill the policy's towers (1: the actor's; 3: actor, reward critic,
    cost critic) from a reference torch file, in place."""
    by_role = read_reference_checkpoint(path)
    for (role, _), tower in zip(TOWER_PREFIXES, towers):
        tower.load_state_dict(select_state_dict(by_role[role], tower.state_dict(), f"{path} ({role} tower)"))


@torch.no_grad()
def load_reference_checkpoint(path: str, train_state, cfg=None):
    """Load a reference torch file into a TrainState's tower parameters (the
    live policy's), shapes checked; returns the TrainState. Towers only: the
    frozen encoders keep their weights. `cfg`, when given, must describe as
    many towers as the TrainState holds."""
    params = train_state.tower_params
    num_towers = len({name.split(".", 1)[0] for name in params})
    if cfg is not None and cfg.model.num_towers != num_towers:
        raise ValueError(f"cfg has {cfg.model.num_towers} towers, the train state {num_towers}")
    by_role = read_reference_checkpoint(path)
    for t, (role, _) in enumerate(TOWER_PREFIXES[:num_towers]):
        live = {name.split(".", 1)[1]: p for name, p in params.items() if name.startswith(f"{t}.")}
        for key, src in select_state_dict(by_role[role], live, f"{path} ({role} tower)").items():
            live[key].copy_(src)
    return train_state


# ---------------------------------------------------------------------------
# frozen encoders
# ---------------------------------------------------------------------------


def interpolate_pos_embed(pos_embed, src_grid: tuple, dst_grid: tuple) -> torch.Tensor:
    """Bicubic-interpolate ViT patch position embeddings (1, 1+S, D) ->
    (1, 1+G, D) for the target grid, once, at conversion time (the reference
    re-interpolates inside every DINOv2 forward)."""
    pos = torch.as_tensor(pos_embed)
    cls_tok, patch = pos[:, :1], pos[:, 1:]
    sh, sw = src_grid
    dh, dw = dst_grid
    t = patch.reshape(1, sh, sw, -1).permute(0, 3, 1, 2)
    t = F.interpolate(t, size=(dh, dw), mode="bicubic", antialias=True)
    t = t.permute(0, 2, 3, 1).reshape(1, dh * dw, -1)
    return torch.cat([cls_tok, t], dim=1)


def import_dinov2(sd: Mapping[str, Any], depth: int = 12, grid=(16, 27)) -> Dict[str, torch.Tensor]:
    """torch-hub dinov2 state dict -> the port's DinoViT state dict: the keys
    the JAX importer reads, with pos_embed interpolated to `grid`."""
    t = lambda k: torch.as_tensor(sd[k])
    out = {
        "patch_embed.proj.weight": t("patch_embed.proj.weight"),
        "patch_embed.proj.bias": t("patch_embed.proj.bias"),
        "cls_token": t("cls_token"),
        "norm.weight": t("norm.weight"),
        "norm.bias": t("norm.bias"),
    }
    pos = t("pos_embed")
    side = int(round((pos.shape[1] - 1) ** 0.5))
    out["pos_embed"] = interpolate_pos_embed(pos, (side, side), grid)
    names = ("norm1", "norm2", "attn.qkv", "attn.proj", "mlp.fc1", "mlp.fc2")
    for i in range(depth):
        for n in names:
            for leaf in ("weight", "bias"):
                out[f"blocks.{i}.{n}.{leaf}"] = t(f"blocks.{i}.{n}.{leaf}")
        for ls in ("ls1", "ls2"):
            out[f"blocks.{i}.{ls}.gamma"] = t(f"blocks.{i}.{ls}.gamma")
    return out


def import_t5(sd: Mapping[str, Any], num_layers: int = 6) -> Dict[str, torch.Tensor]:
    """HF T5EncoderModel state dict -> the port's T5Encoder state dict: the
    keys the JAX importer reads."""
    keys: List[str] = ["shared.weight", "encoder.final_layer_norm.weight"]
    for i in range(num_layers):
        pre = f"encoder.block.{i}.layer"
        keys += [f"{pre}.0.layer_norm.weight", f"{pre}.1.layer_norm.weight"]
        keys += [f"{pre}.0.SelfAttention.{n}.weight" for n in ("q", "k", "v", "o")]
        keys += [f"{pre}.1.DenseReluDense.{n}.weight" for n in ("wi", "wo")]
        if i == 0:
            keys.append(f"{pre}.0.SelfAttention.relative_attention_bias.weight")
    return {k: torch.as_tensor(sd[k]) for k in keys}



def _strip_prefix(sd: Mapping[str, Any], prefix: str) -> Mapping[str, Any]:
    """The keys under `prefix`, stripped of it, when any key has it; else sd."""
    if any(k.startswith(prefix) for k in sd):
        return {k[len(prefix) :]: v for k, v in sd.items() if k.startswith(prefix)}
    return sd


def import_siglip_trunk(sd: Mapping[str, Any], depth: int = 12) -> Dict[str, torch.Tensor]:
    """open_clip / timm SigLIP ViT trunk state dict -> the port's DinoViT
    state dict (a patch-only trunk: no CLS token, no LayerScale). Accepts
    bare timm keys (`patch_embed.proj...`) or the open_clip checkpoint
    (`visual.trunk.`-prefixed). SigLIP-256's `pos_embed` is already the
    16x16 grid: no interpolation."""
    sd = _strip_prefix(sd, "visual.trunk.")
    keys = ["patch_embed.proj.weight", "patch_embed.proj.bias", "pos_embed", "norm.weight", "norm.bias"]
    for i in range(depth):
        for n in ("norm1", "norm2", "attn.qkv", "attn.proj", "mlp.fc1", "mlp.fc2"):
            keys += [f"blocks.{i}.{n}.weight", f"blocks.{i}.{n}.bias"]
    return {k: torch.as_tensor(sd[k]) for k in keys}


def import_siglip_text(sd: Mapping[str, Any], num_layers: int = 12) -> Dict[str, torch.Tensor]:
    """open_clip SigLIP text tower (TextTransformer) state dict -> the port's
    SigLIPTextEncoder state dict, names kept. Accepts bare TextTransformer
    keys (`token_embedding...`) or the open_clip checkpoint (`text.`-prefixed)."""
    sd = _strip_prefix(sd, "text.")
    keys = ["token_embedding.weight", "positional_embedding", "ln_final.weight", "ln_final.bias"]
    for i in range(num_layers):
        pre = f"transformer.resblocks.{i}"
        keys += [f"{pre}.attn.in_proj_weight", f"{pre}.attn.in_proj_bias"]
        for n in ("ln_1", "ln_2", "attn.out_proj", "mlp.c_fc", "mlp.c_proj"):
            keys += [f"{pre}.{n}.weight", f"{pre}.{n}.bias"]
    return {k: torch.as_tensor(sd[k]) for k in keys}
