"""Bounding-box sensors: ground-truth (segmentation-derived) and detector-based.

Copy of `safevla_tpu/envs/bbox_sensors.py`; `load_detic_detector` builds
the Detic model on the card unless asked for another device.
Counterparts of the reference's GT + Detic bbox sensor family
(reference: environment/navigation_sensors.py:267-965 —
TaskRelevantObjectBBoxSensor, SlowAccurateObjectBBoxSensor, and the
OnlineEval variants). Boxes use the 10-vector layout of utils/bbox.py:
[x1, y1, x2, y2, area] for the best target instance + the same for its
receptacle (EMPTY_BBOX when absent).
"""

from __future__ import annotations

import logging
from typing import List, Optional

import numpy as np

from safevla_tpu_torch.constants import EMPTY_BBOX
from safevla_tpu_torch.envs.sensors import Sensor
from safevla_tpu_torch.utils.bbox import bbox_from_mask


def _task_target_object_ids(task) -> List[str]:
    info = task.task_info
    ids: List[str] = []
    for synset in info.get("synsets", []):
        ids += info.get("synset_to_object_ids", {}).get(synset, [])
    return ids


class TaskRelevantObjectBBoxSensor(Sensor):
    """Largest visible target-instance box from GT instance segmentation."""

    def __init__(self, uuid: str = "nav_task_relevant_object_bbox", which_camera: str = "nav"):
        super().__init__(uuid)
        self.which_camera = which_camera

    def get_observation(self, env, task) -> np.ndarray:
        best = list(EMPTY_BBOX)
        get_mask = getattr(env, "get_segmentation_mask_of_object", None)
        if get_mask is not None:
            for oid in _task_target_object_ids(task):
                try:
                    mask = get_mask(oid, which_camera=self.which_camera)
                except Exception:
                    continue
                box = bbox_from_mask(mask)
                if box[4] > best[4] or best[4] == 0 and box[4] > 0:
                    best = box
        return np.array(best + list(EMPTY_BBOX), dtype=np.float32)


class SlowAccurateObjectBBoxSensor(TaskRelevantObjectBBoxSensor):
    """Forces a fresh segmentation render before reading masks
    (reference SlowAccurateObjectBBoxSensor)."""

    def get_observation(self, env, task) -> np.ndarray:
        step = getattr(env, "step", None)
        if step is not None:
            try:
                step(action="Pass", renderImageSynthesis=True)
            except Exception:
                pass
        return super().get_observation(env, task)


class DetectorBBoxSensor(Sensor):
    """Open-vocabulary detector boxes (Detic in the reference,
    utils/detic_utils.py). Takes any `detector` with
    `detect(image, vocabulary) -> [(x1, y1, x2, y2, score), ...]`."""

    def __init__(
        self,
        detector,
        uuid: str = "nav_accurate_object_bbox",
        which_camera: str = "nav",
        score_threshold: float = 0.3,
    ):
        super().__init__(uuid)
        self.detector = detector
        self.which_camera = which_camera
        self.score_threshold = score_threshold

    def get_observation(self, env, task) -> np.ndarray:
        frame = (
            env.navigation_camera if self.which_camera == "nav" else env.manipulation_camera
        )
        vocab = [s.split(".")[0] for s in task.task_info.get("synsets", [])]
        best = list(EMPTY_BBOX)
        if vocab and self.detector is not None:
            for (x1, y1, x2, y2, score) in self.detector.detect(frame, vocab):
                if score < self.score_threshold:
                    continue
                area = max(0, x2 - x1) * max(0, y2 - y1)
                if area > best[4] or best[4] == 0 and area > 0:
                    best = [x1, y1, x2, y2, area]
        return np.array(best + list(EMPTY_BBOX), dtype=np.float32)


class TaskRelevantObjectBBoxSensorDetic(Sensor):
    """Open-vocab detected target box for non-GT evaluation (reference
    TaskRelevantObjectBBoxSensorDeticOnlineEvalDetic,
    navigation_sensors.py:873-965): detect the task's target lemma in the
    chosen camera, pick the best-scoring box above the per-lemma threshold.
    Re-detection is skipped while the frame is unchanged (the reference's
    last_rgb cache), since detection dominates eval step time."""

    def __init__(
        self,
        detector,
        uuid: str = "task_relevant_object_bbox",
        which_camera: str = "nav",
    ):
        super().__init__(uuid)
        self.detector = detector
        self.which_camera = which_camera
        self._last_rgb: Optional[np.ndarray] = None
        self._last_bbox: Optional[np.ndarray] = None

    def get_observation(self, env, task) -> np.ndarray:
        from safevla_tpu_torch.envs.detic import select_best_box
        from safevla_tpu_torch.utils.instructions import best_lemma

        frame = (
            env.navigation_camera if self.which_camera == "nav" else env.manipulation_camera
        )
        if (
            self._last_rgb is not None
            and self._last_rgb.shape == frame.shape
            and np.array_equal(self._last_rgb, frame)
        ):
            return self._last_bbox
        lemma = best_lemma(task.task_info["synsets"][0])
        dets = self.detector.detect(frame, [lemma])
        boxes = [d[:4] for d in dets]
        scores = [d[4] for d in dets]
        bbox = select_best_box(boxes, scores, [lemma] * len(boxes), lemma)
        self._last_rgb = frame.copy()
        self._last_bbox = bbox
        return bbox


class NullDetector:
    """Placeholder detector: never detects (GT-detection eval path does not
    need one; plug a real open-vocab detector in for non-GT eval)."""

    def detect(self, image: np.ndarray, vocabulary: List[str]):
        return []


_LOG = logging.getLogger(__name__)
_logged_null_detector = False


def load_detic_detector(
    config_path: Optional[str] = None,
    weights_path: Optional[str] = None,
    device: str = "cuda",
):
    """Load the Detic open-vocab detector when detectron2 + the Detic repo
    are installed (reference utils/detic_utils.py); NullDetector otherwise
    so the GT-detection eval path keeps working without the heavy stack
    (logged once per process)."""
    try:  # pragma: no cover - heavy optional dependency
        from safevla_tpu_torch.envs.detic import DeticDetector, DeticPredictor

        kwargs = dict(min_size_test=640, max_size_test=640, device=device)
        if config_path:
            kwargs["config_file"] = config_path
        if weights_path:
            kwargs["model_weights_file"] = weights_path
        return DeticDetector(DeticPredictor(**kwargs))
    except ImportError as e:
        global _logged_null_detector
        if not _logged_null_detector:
            _LOG.warning("Detic unavailable (%s); using NullDetector", e)
            _logged_null_detector = True
        return NullDetector()
