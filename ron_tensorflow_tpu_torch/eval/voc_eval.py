"""Official-protocol Pascal VOC evaluator (offline, numpy).

A copy of `ron_tensorflow_tpu/eval/voc_eval.py` (numpy only).

Same semantics as the reference's py-faster-rcnn-derived evaluator
(ref: datasets/voc_eval.py:28-295 `DetectorEvalPascal`): detections in
VOCdevkit `det_<set>_<cls>.txt` format (1-based pixel coords), annotations
parsed from XML with 0-based boxes, greedy per-class matching at IoU 0.5
with difficult-aware TP/FP marking, and the 11-point (VOC07) or envelope
(VOC12) AP. Kept as plain numpy — this runs once per eval on host.

The implementation is structured around in-memory detection lists rather
than the reference's mandatory intermediate text files; writing/reading the
VOCdevkit files is still supported for drop-in interoperability.
"""

from __future__ import annotations

import os
import pickle
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..data.voc import VOC_CLASSES, parse_annotation


def voc_ap(recall: np.ndarray, precision: np.ndarray, use_07_metric: bool = True) -> float:
    """AP from a PR curve (ref: datasets/voc_eval.py:130-162)."""
    if use_07_metric:
        ap = 0.0
        for t in np.arange(0.0, 1.1, 0.1):
            mask = recall >= t
            p = np.max(precision[mask]) if mask.any() else 0.0
            ap += p / 11.0
        return float(ap)
    mrec = np.concatenate([[0.0], recall, [1.0]])
    mpre = np.concatenate([[0.0], precision, [0.0]])
    mpre = np.maximum.accumulate(mpre[::-1])[::-1]
    idx = np.where(mrec[1:] != mrec[:-1])[0]
    return float(np.sum((mrec[idx + 1] - mrec[idx]) * mpre[idx + 1]))


class ClassGroundTruth:
    """Per-image GT boxes of one class with match bookkeeping."""

    def __init__(self):
        self.by_image: Dict[str, Dict] = {}
        self.npos = 0

    def add_image(self, image_id: str, boxes: np.ndarray, difficult: np.ndarray):
        self.by_image[image_id] = {
            "bbox": boxes.astype(float),
            "difficult": difficult.astype(bool),
            "det": np.zeros(len(boxes), bool),
        }
        self.npos += int((~difficult.astype(bool)).sum())


def evaluate_class(
    detections: Sequence[Tuple[str, float, float, float, float, float]],
    gt: ClassGroundTruth,
    ovthresh: float = 0.5,
    use_07_metric: bool = True,
):
    """Greedy VOC matching for one class.

    detections: iterable of (image_id, score, x1, y1, x2, y2) pixel coords.
    Returns (recall, precision, ap); (-1, -1, -1) with no detections —
    matching the reference's empty-file behavior
    (ref: datasets/voc_eval.py:233-295).
    """
    if not detections:
        return -1.0, -1.0, -1.0
    image_ids = [d[0] for d in detections]
    scores = np.array([d[1] for d in detections], float)
    bb_all = np.array([d[2:6] for d in detections], float)
    order = np.argsort(-scores)
    bb_all = bb_all[order]
    image_ids = [image_ids[i] for i in order]

    nd = len(image_ids)
    tp = np.zeros(nd)
    fp = np.zeros(nd)
    for d in range(nd):
        rec = gt.by_image.get(image_ids[d])
        bb = bb_all[d]
        ovmax = -np.inf
        jmax = -1
        if rec is not None and rec["bbox"].size > 0:
            g = rec["bbox"]
            ixmin = np.maximum(g[:, 0], bb[0])
            iymin = np.maximum(g[:, 1], bb[1])
            ixmax = np.minimum(g[:, 2], bb[2])
            iymax = np.minimum(g[:, 3], bb[3])
            iw = np.maximum(ixmax - ixmin, 0.0)
            ih = np.maximum(iymax - iymin, 0.0)
            inter = iw * ih
            union = (
                (bb[2] - bb[0]) * (bb[3] - bb[1])
                + (g[:, 2] - g[:, 0]) * (g[:, 3] - g[:, 1])
                - inter
            )
            overlaps = inter / union
            ovmax = overlaps.max()
            jmax = int(overlaps.argmax())
        if ovmax > ovthresh:
            if not rec["difficult"][jmax]:
                if not rec["det"][jmax]:
                    tp[d] = 1.0
                    rec["det"][jmax] = True
                else:
                    fp[d] = 1.0
        else:
            fp[d] = 1.0

    fp = np.cumsum(fp)
    tp = np.cumsum(tp)
    recall = tp / float(gt.npos) if gt.npos > 0 else np.zeros_like(tp)
    precision = tp / np.maximum(tp + fp, np.finfo(np.float64).eps)
    return recall, precision, voc_ap(recall, precision, use_07_metric)


class PascalVocEvaluator:
    """End-to-end official evaluation over a VOCdevkit directory.

    Drop-in equivalent of `DetectorEvalPascal.evaluate_detections`
    (ref: datasets/voc_eval.py:28-129): feed `all_boxes[cls][image_index] =
    np.array([[x1, y1, x2, y2, score], ...])` (0-based pixel coords, class
    indices 1..20 like the reference's box_list), get per-class AP + mAP.
    """

    def __init__(
        self,
        voc_root: str,
        set_type: str = "test",
        output_dir: Optional[str] = None,
        year_dir: str = "VOC2007",
    ):
        self.root = os.path.join(voc_root, year_dir)
        self.set_type = set_type
        self.output_dir = output_dir
        self.image_ids: List[str] = []
        setfile = os.path.join(self.root, "ImageSets", "Main", set_type + ".txt")
        with open(setfile) as f:
            self.image_ids = [line.strip() for line in f if line.strip()]
        self._annotations = None

    def _load_annotations(self) -> Dict[str, List[Dict]]:
        """XML annotations, pickle-cached (ref: voc_eval.py:199-214)."""
        if self._annotations is not None:
            return self._annotations
        cache = None
        if self.output_dir:
            os.makedirs(self.output_dir, exist_ok=True)
            cache = os.path.join(self.output_dir, "annots.pkl")
            if os.path.isfile(cache):
                with open(cache, "rb") as f:
                    self._annotations = pickle.load(f)
                    return self._annotations
        recs = {}
        for image_id in self.image_ids:
            xml = os.path.join(self.root, "Annotations", image_id + ".xml")
            ann = parse_annotation(xml)
            h, w = ann.shape[0], ann.shape[1]
            objs = []
            for o in ann.objects:
                # back to 0-based pixel corners (ref: voc_eval.py:67-71)
                objs.append(
                    {
                        "name": o.label_text,
                        "difficult": o.difficult,
                        "bbox": [
                            o.bbox[1] * w - 1,
                            o.bbox[0] * h - 1,
                            o.bbox[3] * w - 1,
                            o.bbox[2] * h - 1,
                        ],
                    }
                )
            recs[image_id] = objs
        if cache:
            with open(cache, "wb") as f:
                pickle.dump(recs, f)
        self._annotations = recs
        return recs

    def write_results_files(self, all_boxes, directory: str) -> None:
        """VOCdevkit det_<set>_<cls>.txt files, 1-based coords
        (ref: voc_eval.py:86-100)."""
        os.makedirs(directory, exist_ok=True)
        for ci, cls in enumerate(VOC_CLASSES):
            path = os.path.join(directory, f"det_{self.set_type}_{cls}.txt")
            with open(path, "w") as f:
                for ii, image_id in enumerate(self.image_ids):
                    dets = all_boxes[ci + 1][ii]
                    if len(dets) == 0:
                        continue
                    for row in np.asarray(dets):
                        f.write(
                            f"{image_id} {row[4]:.3f} {row[0] + 1:.1f} "
                            f"{row[1] + 1:.1f} {row[2] + 1:.1f} {row[3] + 1:.1f}\n"
                        )

    def evaluate(self, all_boxes, use_07_metric: bool = True):
        """Returns (mAP, {class: ap}). all_boxes layout as in the reference's
        realtime evaluator (ref: ron_eval.py:563-592)."""
        recs = self._load_annotations()
        aps = {}
        for ci, cls in enumerate(VOC_CLASSES):
            gt = ClassGroundTruth()
            for image_id in self.image_ids:
                objs = [o for o in recs[image_id] if o["name"] == cls]
                boxes = np.array([o["bbox"] for o in objs]) if objs else np.zeros((0, 4))
                difficult = np.array([o["difficult"] for o in objs]) if objs else np.zeros((0,))
                gt.add_image(image_id, boxes, difficult)
            dets = []
            for ii, image_id in enumerate(self.image_ids):
                rows = np.asarray(all_boxes[ci + 1][ii])
                for row in rows.reshape(-1, 5):
                    dets.append((image_id, float(row[4]), *map(float, row[:4])))
            _, _, ap = evaluate_class(dets, gt, use_07_metric=use_07_metric)
            aps[cls] = ap
        valid = [v for v in aps.values() if v >= 0]
        mean_ap = float(np.mean(valid)) if valid else 0.0
        return mean_ap, aps
