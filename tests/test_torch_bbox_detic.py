"""The port's bounding-box utilities, bbox sensors and Detic pieces against the
JAX package's, on inputs made with numpy from a seed (exact equality: the
host code has no floating-point kernel). The detectron2 stack is on neither
machine, so Detic is held on its pure pieces, as `tests/test_detic.py` holds
JAX's: box resizing with the reference's cutoff quirk, the best-box policy
with its per-lemma thresholds, the sensor's frame cache, and
`load_detic_detector` returning a `NullDetector`."""

import inspect
import logging

import numpy as np
import pytest

from safevla_tpu.envs import bbox_sensors as jbs
from safevla_tpu.envs import detic as jdetic
from safevla_tpu.utils import bbox as jbbox
from safevla_tpu_torch.constants import EMPTY_BBOX, EMPTY_DOUBLE_BBOX
from safevla_tpu_torch.envs import bbox_sensors as pbs
from safevla_tpu_torch.envs import detic as pdetic
from safevla_tpu_torch.utils import bbox as pbbox


def _same(a, b):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert np.asarray(a).dtype == np.asarray(b).dtype


def test_bbox_utils_match_jax():
    rng = np.random.default_rng(0)
    for shape in ((10,), (6, 10), (2, 3, 10)):
        a, b = rng.integers(0, 400, shape).astype(np.float64), rng.integers(0, 400, shape).astype(np.float64)
        _same(pbbox.get_best_of_two_bboxes(a, b), jbbox.get_best_of_two_bboxes(a, b))
    for density in (0.0, 0.01, 0.3):
        mask = rng.random((24, 40)) < density
        assert pbbox.bbox_from_mask(mask) == jbbox.bbox_from_mask(mask)
    assert pbbox.bbox_from_mask(np.zeros((4, 4), bool)) == EMPTY_BBOX


class _SegEnv:
    """Masks of random rectangles per object id, and a camera frame."""

    def __init__(self, seed):
        rng = np.random.default_rng(seed)
        self.masks = {}
        for oid in ("Mug|1", "Mug|2", "Vase|3"):
            m = np.zeros((32, 48), bool)
            if rng.random() < 0.8:
                y, x = rng.integers(0, 28), rng.integers(0, 44)
                m[y : y + rng.integers(1, 8), x : x + rng.integers(1, 12)] = True
            self.masks[oid] = m
        self.navigation_camera = rng.integers(0, 256, (32, 48, 3), dtype=np.uint8)
        self.manipulation_camera = rng.integers(0, 256, (32, 48, 3), dtype=np.uint8)
        self.steps = []

    def get_segmentation_mask_of_object(self, oid, which_camera="nav"):
        if oid not in self.masks:
            raise KeyError(oid)
        return self.masks[oid]

    def step(self, **kwargs):
        self.steps.append(kwargs)


class _Task:
    task_info = {
        "synsets": ["mug.n.01", "vase.n.01"],
        "synset_to_object_ids": {"mug.n.01": ["Mug|1", "Mug|2", "Mug|9"], "vase.n.01": ["Vase|3"]},
    }


class _RandomDetector:
    def __init__(self, seed):
        self.rng = np.random.default_rng(seed)
        self.calls = []

    def detect(self, image, vocabulary):
        self.calls.append(list(vocabulary))
        n = self.rng.integers(0, 5)
        xy = self.rng.uniform(0, 40, (n, 2))
        wh = self.rng.uniform(-2, 12, (n, 2))
        return [(x, y, x + w, y + h, s) for (x, y), (w, h), s in zip(xy, wh, self.rng.uniform(0, 1, n))]


@pytest.mark.parametrize("camera", ["nav", "manip"])
def test_bbox_sensors_match_jax(camera):
    for seed in range(12):
        env_j, env_p = _SegEnv(seed), _SegEnv(seed)
        for name in ("TaskRelevantObjectBBoxSensor", "SlowAccurateObjectBBoxSensor"):
            got = getattr(pbs, name)(which_camera=camera).get_observation(env_p, _Task())
            _same(got, getattr(jbs, name)(which_camera=camera).get_observation(env_j, _Task()))
        assert env_p.steps == env_j.steps == [{"action": "Pass", "renderImageSynthesis": True}]
        det_j, det_p = _RandomDetector(seed), _RandomDetector(seed)
        for _ in range(3):
            got = pbs.DetectorBBoxSensor(det_p, which_camera=camera).get_observation(env_p, _Task())
            _same(got, jbs.DetectorBBoxSensor(det_j, which_camera=camera).get_observation(env_j, _Task()))
        assert det_p.calls == det_j.calls == [["mug", "vase"]] * 3


def test_detic_sensor_matches_jax_and_caches_by_frame():
    det_j, det_p = _RandomDetector(4), _RandomDetector(4)
    sj = jbs.TaskRelevantObjectBBoxSensorDetic(det_j, which_camera="manip")
    sp = pbs.TaskRelevantObjectBBoxSensorDetic(det_p, which_camera="manip")
    env_j, env_p = _SegEnv(0), _SegEnv(0)
    for t in range(8):
        if t % 3 == 2:  # a new frame: detect again
            env_j.manipulation_camera = env_j.manipulation_camera + 1
            env_p.manipulation_camera = env_p.manipulation_camera + 1
        _same(sp.get_observation(env_p, _Task()), sj.get_observation(env_j, _Task()))
    assert det_p.calls == det_j.calls and len(det_p.calls) == 3


def test_detic_box_policy_matches_jax():
    rng = np.random.default_rng(1)
    for _ in range(50):
        boxes = rng.uniform(0, 300, (rng.integers(1, 6), 4)).tolist()
        size0, size1 = tuple(rng.integers(50, 700, 2)), tuple(rng.integers(50, 700, 2))
        cut = int(rng.integers(0, 8))
        assert pdetic.resize_boxes(boxes, size0, size1, cut) == jdetic.resize_boxes(boxes, size0, size1, cut)
        scores = rng.uniform(0.2, 0.7, len(boxes)).tolist()
        for lemma in ("mug", "toaster", "laptop", "bed"):
            _same(pdetic.select_best_box(boxes, scores, [lemma] * len(boxes), lemma),
                  jdetic.select_best_box(boxes, scores, [lemma] * len(boxes), lemma))
    # the reference's quirk: scale, then a fixed 6 px shift left
    assert pdetic.resize_boxes([[10, 20, 110, 220]], (100, 100), (200, 200)) == [[14, 40, 214, 440]]
    # 0.4 is below the default 0.5 but above the relaxed 0.3 of a mug
    _same(pdetic.select_best_box([[1, 2, 11, 22]], [0.4], ["x"], "toaster"), np.array(EMPTY_DOUBLE_BBOX, np.float64))
    np.testing.assert_array_equal(pdetic.select_best_box([[1, 2, 11, 22]], [0.4], ["x"], "mug")[:5], [1, 2, 11, 22, 200])
    _same(pdetic.select_best_box([], [], [], "mug"), np.array(EMPTY_DOUBLE_BBOX, np.float64))
    assert pdetic.RELAXED_THRESHOLD_LEMMAS == jdetic.RELAXED_THRESHOLD_LEMMAS


def test_load_detic_detector_without_the_stack(caplog, monkeypatch):
    monkeypatch.setattr(pbs, "_logged_null_detector", False)
    with caplog.at_level(logging.WARNING, logger=pbs.__name__):
        dets = [pbs.load_detic_detector(), pbs.load_detic_detector(device="cpu")]
    assert all(isinstance(d, pbs.NullDetector) for d in dets)
    assert isinstance(jbs.load_detic_detector(), jbs.NullDetector)
    assert dets[0].detect(np.zeros((4, 4, 3), np.uint8), ["mug"]) == []
    assert [r.message for r in caplog.records].count(caplog.records[0].message) == 1  # logged once
    assert "NullDetector" in caplog.records[0].message
    # the predictor's model runs on the card unless asked for the CPU
    assert inspect.signature(pdetic.DeticPredictor).parameters["device"].default == "cuda"
    assert inspect.signature(pbs.load_detic_detector).parameters["device"].default == "cuda"
    monkeypatch.delenv("DETIC_REPO_PATH", raising=False)
    with pytest.raises(ImportError, match="Detic repo not found"):
        pdetic.create_detic_cfg("cfg.yaml", None, 0.3, False, "cpu")
