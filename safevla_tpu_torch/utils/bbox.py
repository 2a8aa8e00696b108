"""Bounding-box utilities (reference utils/bbox_utils.py); a copy of
`safevla_tpu/utils/bbox.py`.

Boxes are 10-vectors: [x1, y1, x2, y2, size] for the target object followed by
the same 5 for its receptacle; `EMPTY_BBOX` marks absence.
"""

from __future__ import annotations

import numpy as np

from safevla_tpu_torch.constants import EMPTY_BBOX, EMPTY_DOUBLE_BBOX  # noqa: F401


def get_best_of_two_bboxes(bbox_1: np.ndarray, bbox_2: np.ndarray) -> np.ndarray:
    """Per-slot pick of whichever detector found the bigger box
    (reference bbox_utils.py:71-90): object slot by column 4, receptacle slot
    by column 9."""
    assert bbox_1.shape == bbox_2.shape
    assert bbox_1.shape[-1] == 10
    out = np.copy(bbox_1)
    obj_2_bigger = bbox_1[..., 4] < bbox_2[..., 4]
    out[obj_2_bigger] = bbox_2[obj_2_bigger]
    rec = np.copy(bbox_1)
    rec_2_bigger = bbox_1[..., 9] < bbox_2[..., 9]
    rec[rec_2_bigger] = bbox_2[rec_2_bigger]
    out[..., 5:9] = rec[..., 5:9]
    return out


def bbox_from_mask(mask: np.ndarray) -> list:
    """Segmentation mask -> [x1, y1, x2, y2, area] (EMPTY_BBOX if empty)."""
    ys, xs = np.nonzero(mask)
    if len(ys) == 0:
        return list(EMPTY_BBOX)
    x1, x2 = int(xs.min()), int(xs.max())
    y1, y2 = int(ys.min()), int(ys.max())
    return [x1, y1, x2, y2, (x2 - x1 + 1) * (y2 - y1 + 1)]
