"""Action-space size, image-normalisation and robot / camera constants.

Copy of `safevla_tpu/constants.py`: the action list, the motion, arm and
camera constants the FakeController, the AI2-THOR controller and the task
samplers read, the empty bounding boxes, the action names, the navigation
subset, the robot command mapping, and the normalisation stats. The action
list keeps the same order and the same `ACTION_DICT` override, so
`NUM_ACTIONS` agrees with the JAX package.
"""

from __future__ import annotations

import json
import os

from safevla_tpu_torch.types import THORActions

AGENT_ROTATION_DEG = 30
AGENT_MOVEMENT_CONSTANT = 0.2
HORIZON = 0
ARM_MOVE_CONSTANT = 0.1
WRIST_ROTATION = 10

EMPTY_BBOX = [1000, 1000, 1000, 1000, 0]
EMPTY_DOUBLE_BBOX = EMPTY_BBOX + EMPTY_BBOX

ORIGINAL_INTEL_W, ORIGINAL_INTEL_H = 1280, 720
INTEL_CAMERA_WIDTH, INTEL_CAMERA_HEIGHT = 396, 224
INTEL_WIDTH_CROPPED, INTEL_HEIGHT_CROPPED = 384, 224
INTEL_VERTICAL_FOV = 59

MAXIMUM_DISTANCE_ARM_FROM_AGENT_CENTER = 0.8673349051766235
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

STRETCH_ACTION_LONG_NAMES = {
    THORActions.move_ahead: "move_ahead",
    THORActions.rotate_right: "rotate_right",
    THORActions.rotate_left: "rotate_left",
    THORActions.move_back: "move_back",
    THORActions.done: "done",
    THORActions.sub_done: "sub_done",
    THORActions.rotate_left_small: "rotate_left_small",
    THORActions.rotate_right_small: "rotate_right_small",
    THORActions.pickup: "pickup",
    THORActions.dropoff: "dropoff",
    THORActions.move_arm_in: "move_arm_in",
    THORActions.move_arm_out: "move_arm_out",
    THORActions.move_arm_up: "move_arm_up",
    THORActions.move_arm_down: "move_arm_down",
    THORActions.wrist_open: "wrist_open",
    THORActions.wrist_close: "wrist_close",
    THORActions.move_arm_down_small: "move_arm_down_small",
    THORActions.move_arm_in_small: "move_arm_in_small",
    THORActions.move_arm_out_small: "move_arm_out_small",
    THORActions.move_arm_up_small: "move_arm_up_small",
}

# the pure navigation actions, and the indices of the others in the logit
# layout (reference dinov2_vits_tsfm_base.py:272-289)
NAV_ACTIONS = [
    THORActions.move_ahead,
    THORActions.rotate_right,
    THORActions.rotate_left,
    THORActions.move_back,
    THORActions.done,
    THORActions.rotate_right_small,
    THORActions.rotate_left_small,
]
NON_NAV_ACTION_INDS = [i for i, a in enumerate(ALL_STRETCH_ACTIONS) if a not in NAV_ACTIONS]

# action -> AI2-THOR (or real robot) command (reference:
# stretch_initialization_utils.py:198-258)
ROBOT_ACTION_MAPPING = {
    THORActions.move_ahead: {"action": "MoveAgent", "args": {"move_scalar": AGENT_MOVEMENT_CONSTANT}},
    THORActions.move_back: {"action": "MoveAgent", "args": {"move_scalar": -AGENT_MOVEMENT_CONSTANT}},
    THORActions.rotate_right: {"action": "RotateAgent", "args": {"move_scalar": AGENT_ROTATION_DEG}},
    THORActions.rotate_left: {"action": "RotateAgent", "args": {"move_scalar": -AGENT_ROTATION_DEG}},
    THORActions.rotate_right_small: {"action": "RotateAgent", "args": {"move_scalar": AGENT_ROTATION_DEG / 5}},
    THORActions.rotate_left_small: {"action": "RotateAgent", "args": {"move_scalar": -AGENT_ROTATION_DEG / 5}},
    THORActions.done: {"action": "Pass", "args": {}},
    THORActions.sub_done: {"action": "Pass", "args": {}},
    THORActions.move_arm_up: {"action": "MoveArmBase", "args": {"move_scalar": ARM_MOVE_CONSTANT}},
    THORActions.move_arm_up_small: {"action": "MoveArmBase", "args": {"move_scalar": ARM_MOVE_CONSTANT / 5}},
    THORActions.move_arm_down: {"action": "MoveArmBase", "args": {"move_scalar": -ARM_MOVE_CONSTANT}},
    THORActions.move_arm_down_small: {"action": "MoveArmBase", "args": {"move_scalar": -ARM_MOVE_CONSTANT / 5}},
    THORActions.move_arm_out: {"action": "MoveArmExtension", "args": {"move_scalar": ARM_MOVE_CONSTANT}},
    THORActions.move_arm_out_small: {"action": "MoveArmExtension", "args": {"move_scalar": ARM_MOVE_CONSTANT / 5}},
    THORActions.move_arm_in: {"action": "MoveArmExtension", "args": {"move_scalar": -ARM_MOVE_CONSTANT}},
    THORActions.move_arm_in_small: {"action": "MoveArmExtension", "args": {"move_scalar": -ARM_MOVE_CONSTANT / 5}},
    THORActions.wrist_open: {"action": "MoveWrist", "args": {"move_scalar": -WRIST_ROTATION}},
    THORActions.wrist_close: {"action": "MoveWrist", "args": {"move_scalar": WRIST_ROTATION}},
    THORActions.pickup: {"action": "GraspTo", "args": {"move_to": -10}},
    THORActions.dropoff: {"action": "GraspTo", "args": {"move_to": 30}},
}

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
