"""CLIP modified-ResNet visual trunk (frozen image encoder).

Counterpart of `safevla_tpu/models/resnet.py` (the reference's `ClipResNet`
encoder: CLIP RN50's stem and four stages, the un-pooled 2048-channel map).
CLIP's ResNet differs from torchvision's:

- a 3-conv stem (width/2, width/2, width) and an average pool, no max pool;
- anti-aliased striding: a stride-2 bottleneck average-pools before its
  final 1x1 conv, and its shortcut is avgpool -> 1x1 conv -> BN;
- every convolution is bias-free (BatchNorm supplies the affine).

Same numerics as the JAX module, which is NHWC: convolutions in the compute
dtype (weights stored in it, one rounding at load as the JAX module's cast at
every use), BatchNorm as an f32 per-channel scale and shift from the running
statistics followed by a cast back to the compute dtype (not folded into the
conv weights: that would move the rounding points), f32 output. The
activations are NCHW tensors in `channels_last` memory, the JAX layout, so
cuDNN takes its NHWC tensor-core paths without transposes. The convolutions
are XLA's in the JAX package, not Pallas kernels, so they are `F.conv2d`
here. At 224x384 the last stage's map is exactly (7, 12) and the adaptive
pool is skipped; other resolutions pool with the ViT's pool matrices.

Module names follow CLIP's `visual.` module (`conv1`, `bn1`, `layer1.0.conv1`,
`layer1.0.downsample.0` / `.1`, BatchNorm's `weight`, `bias`, `running_mean`,
`running_var`), so `import_clip_resnet` is a prefix strip and the JAX
package's importer reads a port state dict.
"""

from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass
from typing import Any, Dict, Mapping, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from safevla_tpu_torch.models.vit import adaptive_pool_matrix


@dataclass(frozen=True)
class ClipResNetConfig:
    width: int = 64
    layers: Tuple[int, ...] = (3, 4, 6, 3)  # RN50
    dtype: torch.dtype = torch.bfloat16

    @property
    def out_dim(self) -> int:
        return self.width * 8 * Bottleneck.expansion


class FrozenBatchNorm(nn.Module):
    """Inference-mode BatchNorm: y = gamma * (x - mean) / sqrt(var + eps) + beta,
    as an f32 scale and shift, cast back to the input's dtype.

    Where no gradient is taken, the scale and shift are computed once and
    reused until a statistic or parameter changes (its version counter or
    storage, as `models/dense.py::cast_param`): an act pays two launches a
    norm, not eight."""

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))
        self._affine = None  # (version key, scale, shift)

    def _scale_shift(self):
        scale = self.weight * torch.reciprocal(torch.sqrt(self.running_var + self.eps))
        return scale[:, None, None], (self.bias - self.running_mean * scale)[:, None, None]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if torch.is_grad_enabled() and self.weight.requires_grad:
            scale, shift = self._scale_shift()
        else:
            tensors = (self.weight, self.bias, self.running_mean, self.running_var)
            key = tuple((t.device, t.data_ptr(), t._version) for t in tensors)
            if self._affine is None or self._affine[0] != key:
                with torch.no_grad():
                    self._affine = (key, *self._scale_shift())
            scale, shift = self._affine[1:]
        if torch.is_grad_enabled() and (x.requires_grad or scale.requires_grad):
            return torch.addcmul(shift, x, scale).to(x.dtype)  # out= has no autograd
        # x * scale + shift in f32, rounded once as it is stored in x's dtype:
        # on the card one pass that reads x and writes its dtype, no f32
        # activation in between
        return torch.addcmul(shift, x, scale, out=torch.empty_like(x))


def _conv(cin: int, cout: int, kernel: int, stride: int, dtype: torch.dtype) -> nn.Conv2d:
    conv = nn.Conv2d(cin, cout, kernel, stride=stride, padding=kernel // 2, bias=False, dtype=dtype)
    conv.weight.data = conv.weight.data.to(memory_format=torch.channels_last)
    return conv


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int, dtype: torch.dtype):
        super().__init__()
        out_ch = planes * self.expansion
        self.stride = stride
        self.conv1 = _conv(inplanes, planes, 1, 1, dtype)
        self.bn1 = FrozenBatchNorm(planes)
        self.conv2 = _conv(planes, planes, 3, 1, dtype)
        self.bn2 = FrozenBatchNorm(planes)
        self.conv3 = _conv(planes, out_ch, 1, 1, dtype)
        self.bn3 = FrozenBatchNorm(out_ch)
        self.downsample = None
        if stride > 1 or inplanes != out_ch:
            # CLIP's ("-1": AvgPool2d, "0": conv, "1": bn); the pool has no
            # parameters, so it runs in forward
            self.downsample = nn.Sequential(
                OrderedDict([("0", _conv(inplanes, out_ch, 1, 1, dtype)), ("1", FrozenBatchNorm(out_ch))])
            )

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        if self.stride > 1:
            y = F.avg_pool2d(y, self.stride)
        y = self.bn3(self.conv3(y))
        identity = x
        if self.downsample is not None:
            if self.stride > 1:
                identity = F.avg_pool2d(identity, self.stride)
            identity = self.downsample(identity)
        return F.relu(y + identity)


class ClipResNet(nn.Module):
    """Frozen CLIP-RN trunk. Input (B, H, W, 3) normalised float -> (B, 7, 12,
    width * 32) f32, the contract of `DinoViT.forward`."""

    def __init__(self, cfg: ClipResNetConfig, pool_grid: Tuple[int, int] = (7, 12)):
        super().__init__()
        self.cfg = cfg
        self.pool_grid = pool_grid
        w, dt = cfg.width, cfg.dtype
        self.conv1 = _conv(3, w // 2, 3, 2, dt)
        self.bn1 = FrozenBatchNorm(w // 2)
        self.conv2 = _conv(w // 2, w // 2, 3, 1, dt)
        self.bn2 = FrozenBatchNorm(w // 2)
        self.conv3 = _conv(w // 2, w, 3, 1, dt)
        self.bn3 = FrozenBatchNorm(w)
        inplanes = w
        for stage, blocks in enumerate(cfg.layers):
            planes = w * 2**stage
            layer = []
            for i in range(blocks):
                layer.append(Bottleneck(inplanes, planes, 2 if (stage > 0 and i == 0) else 1, dt))
                inplanes = planes * Bottleneck.expansion
            self.add_module(f"layer{stage + 1}", nn.Sequential(*layer))
        self._pool = {}  # (gh, gw, device) -> the two pool matrices

    def _pool_matrices(self, gh: int, gw: int, device):
        key = (gh, gw, device)
        if key not in self._pool:
            ph, pw = self.pool_grid
            self._pool[key] = (
                torch.from_numpy(adaptive_pool_matrix(gh, ph)).to(device),
                torch.from_numpy(adaptive_pool_matrix(gw, pw)).to(device),
            )
        return self._pool[key]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # NHWC -> an NCHW view in channels_last memory (no copy)
        x = x.to(self.cfg.dtype).permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.relu(self.bn2(self.conv2(x)))
        x = F.relu(self.bn3(self.conv3(x)))
        x = F.avg_pool2d(x, 2)
        for stage in range(len(self.cfg.layers)):
            x = getattr(self, f"layer{stage + 1}")(x)
        x = x.float().permute(0, 2, 3, 1)  # (B, gh, gw, out_dim)
        gh, gw = x.shape[1:3]
        if (gh, gw) != tuple(self.pool_grid):
            mh, mw = self._pool_matrices(gh, gw, x.device)
            x = torch.einsum("og,bgwd->bowd", mh, x)
            x = torch.einsum("ow,bhwd->bhod", mw, x)
        return x


RESNET_CONFIGS = {
    "clip_rn50": ClipResNetConfig(),
}


def import_clip_resnet(visual_sd: Mapping[str, Any], cfg: ClipResNetConfig = ClipResNetConfig()) -> Dict[str, torch.Tensor]:
    """CLIP `model.visual` state dict -> the port's ClipResNet state dict: the
    keys the JAX importer reads (with or without a leading `visual.`; the
    attention-pool head `attnpool.*` and BatchNorm's `num_batches_tracked`
    are not read, as the reference forward never runs the head)."""
    sd = {(k[len("visual.") :] if k.startswith("visual.") else k): v for k, v in visual_sd.items()}
    bn = ("weight", "bias", "running_mean", "running_var")
    keys = []
    for i in (1, 2, 3):
        keys += [f"conv{i}.weight"] + [f"bn{i}.{n}" for n in bn]
    for stage, blocks in enumerate(cfg.layers):
        for i in range(blocks):
            src = f"layer{stage + 1}.{i}"
            for j in (1, 2, 3):
                keys += [f"{src}.conv{j}.weight"] + [f"{src}.bn{j}.{n}" for n in bn]
            if f"{src}.downsample.0.weight" in sd:
                keys += [f"{src}.downsample.0.weight"] + [f"{src}.downsample.1.{n}" for n in bn]
    return {k: torch.as_tensor(sd[k]) for k in keys}
