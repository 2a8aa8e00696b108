"""Action-space size, image-normalisation and robot / camera constants.

Copy of what the port needs from `safevla_tpu/constants.py` (:14-67,
:132-149): the action list, the motion, arm and camera constants the
FakeController, the AI2-THOR controller and the task samplers read, the
empty bounding boxes, and the normalisation stats. The action list keeps the
same order and the same `ACTION_DICT` override, so `NUM_ACTIONS` agrees with
the JAX package.
"""

from __future__ import annotations

import json
import os

AGENT_ROTATION_DEG = 30
AGENT_MOVEMENT_CONSTANT = 0.2
HORIZON = 0
ARM_MOVE_CONSTANT = 0.1
WRIST_ROTATION = 10

EMPTY_BBOX = [1000, 1000, 1000, 1000, 0]
EMPTY_DOUBLE_BBOX = EMPTY_BBOX + EMPTY_BBOX

INTEL_CAMERA_WIDTH, INTEL_CAMERA_HEIGHT = 396, 224
INTEL_VERTICAL_FOV = 59

PHYSICS_SETTLING_TIME = 1.0
MAXIMUM_SERVER_TIMEOUT = 1200

STRETCH_WRIST_BOUND_1 = 75
STRETCH_WRIST_BOUND_2 = -260

STRETCH_COMMIT_ID = "966bd7758586e05d18f6181f459c0e90ba318bec"

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

# extra arguments of the simulator's arm and navigation actions
# (reference stretch_initialization_utils.py:260-261)
ADDITIONAL_ARM_ARGS = {"returnToStart": True, "speed": 1}
ADDITIONAL_NAVIGATION_ARGS = {**ADDITIONAL_ARM_ARGS, "returnToStart": False}

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
