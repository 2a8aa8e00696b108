"""Detic open-vocabulary detection for non-GT evaluation.

Copy of `safevla_tpu/envs/detic.py`. One difference: `DeticPredictor` runs
its detectron2 model on the card unless the caller passes `device="cpu"`
(the JAX package's default is the CPU), as every entry point of the port
does.

Port of the reference's Detic integration (reference utils/detic_utils.py:
create_detic_cfg l.50-80, resize_boxes l.85-112, DeticPredictor l.115-257;
sensor-side selection logic navigation_sensors.py:873-965). The heavy model
stack (detectron2 + the Detic repo + its CLIP text encoder) loads lazily —
everything around it (config assembly, vocabulary swapping, box resizing,
best-box selection policy) is real, complete code; the pure pieces are
unit-tested without the model.

Usage mirrors the reference:
    predictor = DeticPredictor(min_size_test=640, max_size_test=640)
    predictor.vocabulary = ["mug"]
    instances = predictor(batch_rgb_bhwc)     # list of per-image detections
"""

from __future__ import annotations

import os
import sys
from typing import Any, List, Optional, Sequence, Tuple

import numpy as np
import torch

# per-lemma confidence thresholds (reference navigation_sensors.py:947-949:
# default 0.5, relaxed to the detector's own 0.3 floor for these categories)
RELAXED_THRESHOLD_LEMMAS = ("basketball", "vase", "houseplant", "apple", "laptop", "mug")
DEFAULT_SELECT_THRESHOLD = 0.5
RELAXED_SELECT_THRESHOLD = 0.3


def detic_repo_path() -> Optional[str]:
    """Locate the Detic checkout (reference detic_utils.py:1-22): a sys.path
    entry ending in Detic, or $DETIC_REPO_PATH."""
    for p in sys.path:
        if p.rstrip("/").endswith("Detic"):
            return p
    return os.environ.get("DETIC_REPO_PATH")


def resize_boxes(boxes, original_size, new_size, cutoff_amount: int = 6):
    """Rescale [x1,y1,x2,y2] boxes between image sizes, reproducing the
    reference's horizontal cutoff quirk (detic_utils.py:85-112 applies a
    fixed -6px shift on x after scaling — kept for behavioral parity)."""
    oh, ow = original_size
    nh, nw = new_size
    sx, sy = nw / ow, nh / oh
    out = []
    for x1, y1, x2, y2 in boxes:
        out.append(
            [
                int(x1 * sx) - cutoff_amount,
                int(y1 * sy),
                int(x2 * sx) - cutoff_amount,
                int(y2 * sy),
            ]
        )
    return out


def select_best_box(
    boxes: Sequence[Sequence[float]],
    scores: Sequence[float],
    classes: Sequence[str],
    lemma: str,
) -> np.ndarray:
    """Best-scoring detection -> the 10-vector bbox layout
    ([x1,y1,x2,y2,area] + empty receptacle slot), or EMPTY_DOUBLE_BBOX.

    Reproduces the reference sensor's policy (navigation_sensors.py:938-961):
    integer-cast boxes, area channel appended, per-lemma threshold on the max
    score."""
    from safevla_tpu_torch.constants import EMPTY_BBOX, EMPTY_DOUBLE_BBOX

    if not boxes:
        return np.array(EMPTY_DOUBLE_BBOX, dtype=np.float64)
    cast = []
    for box in boxes:
        b = [int(v) for v in box[:4]]
        b.append((b[3] - b[1]) * (b[2] - b[0]))
        cast.append(b)
    thresh = (
        RELAXED_SELECT_THRESHOLD
        if lemma in RELAXED_THRESHOLD_LEMMAS
        else DEFAULT_SELECT_THRESHOLD
    )
    best_box, best_score, _ = max(zip(cast, scores, classes), key=lambda x: x[1])
    if best_score < thresh:
        return np.array(EMPTY_DOUBLE_BBOX, dtype=np.float64)
    return np.array(list(best_box) + list(EMPTY_BBOX), dtype=np.float64)


def create_detic_cfg(
    config_file: str,
    opts: Optional[List[Any]],
    confidence_threshold: float,
    pred_all_class: bool,
    device: str,
):
    """Assemble the detectron2 config exactly as the reference does
    (detic_utils.py:50-80). Requires detectron2 + Detic + CenterNet2."""
    repo = detic_repo_path()
    if repo is None:
        raise ImportError(
            "Detic repo not found: add it to sys.path or set DETIC_REPO_PATH"
        )
    centernet_path = os.path.join(repo, "third_party/CenterNet2")
    if centernet_path not in sys.path and os.path.exists(centernet_path):
        sys.path.insert(0, centernet_path)
    if repo not in sys.path:
        sys.path.insert(0, repo)

    from detectron2.config import get_cfg
    from centernet.config import add_centernet_config
    from detic.config import add_detic_config

    cfg = get_cfg()
    cfg.MODEL.DEVICE = device
    add_centernet_config(cfg)
    add_detic_config(cfg)
    cfg.merge_from_file(config_file)
    cfg.merge_from_list(opts or [])
    cfg.MODEL.RETINANET.SCORE_THRESH_TEST = confidence_threshold
    cfg.MODEL.ROI_HEADS.SCORE_THRESH_TEST = confidence_threshold
    cfg.MODEL.PANOPTIC_FPN.COMBINE.INSTANCES_CONFIDENCE_THRESH = confidence_threshold
    cfg.MODEL.ROI_BOX_HEAD.ZEROSHOT_WEIGHT_PATH = "rand"  # installed per-vocabulary
    if not pred_all_class:
        cfg.MODEL.ROI_HEADS.ONE_CLASS_PER_PROPOSAL = True
    cfg.MODEL.ROI_BOX_HEAD.CAT_FREQ_PATH = os.path.join(
        repo, cfg.MODEL.ROI_BOX_HEAD.CAT_FREQ_PATH
    )
    cfg.freeze()
    return cfg


class DeticPredictor:
    """Batched Detic predictor with swappable open vocabulary
    (reference detic_utils.py:115-257)."""

    def __init__(
        self,
        vocabulary: Sequence[str] = ("apple", "potato"),
        prompt: str = "a ",
        config_file: str = "Detic_LCOCOI21k_CLIP_SwinB_896b32_4x_ft4x_max-size.yaml",
        model_weights_file: str = "Detic_LCOCOI21k_CLIP_SwinB_896b32_4x_ft4x_max-size.pth",
        min_size_test: Optional[int] = None,
        max_size_test: Optional[int] = None,
        confidence_threshold: float = 0.3,
        pred_all_class: bool = False,
        device: str = "cuda",
    ):
        from detectron2.checkpoint import DetectionCheckpointer
        from detectron2.modeling import build_model

        repo = detic_repo_path()
        if not os.path.exists(config_file) and repo:
            config_file = os.path.join(repo, "configs", config_file)
        if not os.path.exists(model_weights_file) and repo:
            model_weights_file = os.path.join(repo, "models", model_weights_file)

        opts: List[Any] = ["MODEL.WEIGHTS", model_weights_file]
        if min_size_test is not None:
            opts += ["INPUT.MIN_SIZE_TEST", min_size_test]
        if max_size_test is not None:
            opts += ["INPUT.MAX_SIZE_TEST", max_size_test]

        self.cfg = create_detic_cfg(
            config_file=config_file,
            opts=opts,
            confidence_threshold=confidence_threshold,
            pred_all_class=pred_all_class,
            device=device,
        ).clone()
        self.prompt = prompt
        self.model = build_model(self.cfg)
        DetectionCheckpointer(self.model).load(self.cfg.MODEL.WEIGHTS)
        self.model.eval()
        self._text_encoder = None
        self._vocabulary: Optional[Sequence[str]] = None
        self.vocabulary = vocabulary
        assert self.cfg.INPUT.FORMAT == "RGB"

    # -- vocabulary management (zero-shot classifier weight swap) ----------
    @property
    def text_encoder(self):
        if self._text_encoder is None:
            from detic.modeling.text.text_encoder import build_text_encoder

            self._text_encoder = build_text_encoder(pretrain=True)
            self._text_encoder.eval()
        return self._text_encoder

    @property
    def vocabulary(self) -> Sequence[str]:
        return self._vocabulary

    @vocabulary.setter
    def vocabulary(self, vocabulary: Sequence[str]):
        if self._vocabulary is not None and list(self._vocabulary) == list(vocabulary):
            return
        self._vocabulary = list(vocabulary)
        self.model.roi_heads.num_classes = len(self._vocabulary)
        texts = [self.prompt + x for x in self._vocabulary]
        with torch.no_grad():
            zs = self.text_encoder(texts).detach().permute(1, 0).contiguous()
        # the text encoder runs on the CPU; the classifier lives with the model
        zs = zs.to(self.cfg.MODEL.DEVICE)
        zs = torch.cat([zs, zs.new_zeros((zs.shape[0], 1))], dim=1)
        if self.model.roi_heads.box_predictor[0].cls_score.norm_weight:
            zs = torch.nn.functional.normalize(zs, p=2, dim=0)
        for k in range(len(self.model.roi_heads.box_predictor)):
            del self.model.roi_heads.box_predictor[k].cls_score.zs_weight
            self.model.roi_heads.box_predictor[k].cls_score.zs_weight = zs

    # -- inference ----------------------------------------------------------
    def _resize(self, images):
        from detectron2.data.transforms import ResizeShortestEdge
        from torchvision.transforms import Resize

        b, c, h, w = images.shape
        nh, nw = ResizeShortestEdge.get_output_shape(
            oldh=h, oldw=w,
            short_edge_length=self.cfg.INPUT.MIN_SIZE_TEST,
            max_size=self.cfg.INPUT.MAX_SIZE_TEST,
        )
        return Resize((nh, nw), antialias=True)(images)

    def __call__(self, images_bhwc: np.ndarray):
        """RGB uint8 (B, H, W, 3) -> list of per-image detection dicts."""
        with torch.no_grad():
            t = torch.from_numpy(np.ascontiguousarray(images_bhwc)).permute(0, 3, 1, 2)
            b, _, h, w = t.shape
            t = self._resize(t).float()
            inputs = [{"image": t[i], "height": h, "width": w} for i in range(b)]
            return self.model(inputs)


class DeticDetector:
    """Adapter to the sensor-facing `.detect(image, vocabulary)` protocol:
    returns [(x1, y1, x2, y2, score), ...] for the best-matching classes."""

    def __init__(self, predictor: DeticPredictor):
        self.predictor = predictor

    def detect(self, image: np.ndarray, vocabulary: List[str]) -> List[Tuple]:
        self.predictor.vocabulary = vocabulary
        preds = self.predictor(image[None])
        inst = preds[0]["instances"]
        boxes = inst.pred_boxes.tensor.tolist()
        scores = inst.scores.tolist()
        return [tuple(b) + (s,) for b, s in zip(boxes, scores)]
