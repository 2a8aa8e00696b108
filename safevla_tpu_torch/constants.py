"""Action-space size and image-normalisation constants.

Copy of what the serving path needs from `safevla_tpu/constants.py`
(:38-67, :135-149). The action list keeps the same order and the same
`ACTION_DICT` override, so `NUM_ACTIONS` agrees with the JAX package.
"""

from __future__ import annotations

import json
import os

# 20-action discrete space; the order defines the policy's logit layout
# (reference: utils/constants/stretch_initialization_utils.py:145-166).
if os.getenv("ACTION_DICT") is not None:
    with open(os.environ["ACTION_DICT"], "r") as f:
        ALL_STRETCH_ACTIONS = list(json.load(f).keys())
else:
    ALL_STRETCH_ACTIONS = [
        "m", "r", "l", "b", "end", "sub_done", "ls", "rs", "p", "zm",
        "zp", "yp", "ym", "wp", "wm", "yms", "zms", "zps", "yps", "d",
    ]

NUM_ACTIONS = len(ALL_STRETCH_ACTIONS)

# Image-normalisation stats of the DINOv2 preprocessing path
# (reference: architecture/allenact_preprocessors/dino_preprocessors.py:42-43).
DINO_RGB_MEANS = (0.48145466, 0.4578275, 0.40821073)
DINO_RGB_STDS = (0.26862954, 0.26130258, 0.27577711)

# SigLIP preprocessing stats (reference siglip_preprocessors.py:37-38).
SIGLIP_RGB_MEANS = (0.5, 0.5, 0.5)
SIGLIP_RGB_STDS = (0.5, 0.5, 0.5)


def rgb_norm_constants(vision_backbone: str):
    """(means, stds) for the given frozen vision trunk."""
    if "siglip" in vision_backbone.lower():
        return SIGLIP_RGB_MEANS, SIGLIP_RGB_STDS
    return DINO_RGB_MEANS, DINO_RGB_STDS
