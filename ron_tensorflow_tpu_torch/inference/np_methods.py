"""Pure-numpy detection post-processing — the notebook/demo path.

A copy of `ron_tensorflow_tpu/inference/np_methods.py` (numpy only).

Equivalent of the reference's `nets/np_methods.py:23-248` (decode, select,
sort, clip, NMS in numpy), kept for host-side demos and debugging where a
device round-trip is overkill. Semantics match the ops in `ops/`,
which are the production path.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def decode_boxes(locations: np.ndarray, anchors_cyxhw: np.ndarray,
                 prior_scaling=(0.1, 0.1, 0.2, 0.2)) -> np.ndarray:
    """[N, 4] offsets (cx, cy, w, h order) -> corner boxes
    (ref: np_methods.py:23-62 ssd_bboxes_decode)."""
    acy, acx, ah, aw = (anchors_cyxhw[:, i] for i in range(4))
    cx = locations[..., 0] * aw * prior_scaling[0] + acx
    cy = locations[..., 1] * ah * prior_scaling[1] + acy
    w = aw * np.exp(locations[..., 2] * prior_scaling[2])
    h = ah * np.exp(locations[..., 3] * prior_scaling[3])
    return np.stack([cy - h / 2, cx - w / 2, cy + h / 2, cx + w / 2], axis=-1)


def select_boxes(predictions: np.ndarray, boxes: np.ndarray,
                 select_threshold: float = 0.5):
    """Best non-background class per box above threshold
    (ref: np_methods.py:65-97 ssd_bboxes_select). Returns (classes, scores,
    boxes) with only selected rows."""
    sub = predictions[:, 1:]
    classes = np.argmax(sub, axis=1) + 1
    scores = np.max(sub, axis=1)
    mask = scores > select_threshold
    return classes[mask], scores[mask], boxes[mask]


def sort_boxes(classes, scores, boxes, top_k: int = 400):
    """Descending score sort, top_k (ref: np_methods.py:111-121)."""
    idx = np.argsort(-scores)[:top_k]
    return classes[idx], scores[idx], boxes[idx]


def clip_boxes(bbox_ref: np.ndarray, boxes: np.ndarray) -> np.ndarray:
    """(ref: np_methods.py:100-108 bboxes_clip)."""
    out = boxes.copy()
    out[:, 0] = np.maximum(out[:, 0], bbox_ref[0])
    out[:, 1] = np.maximum(out[:, 1], bbox_ref[1])
    out[:, 2] = np.minimum(out[:, 2], bbox_ref[2])
    out[:, 3] = np.minimum(out[:, 3], bbox_ref[3])
    return out


def resize_boxes(bbox_ref: np.ndarray, boxes: np.ndarray) -> np.ndarray:
    """Re-express boxes in the ref-box frame (ref: np_methods.py:124-139)."""
    out = boxes.copy()
    out[:, 0] -= bbox_ref[0]
    out[:, 1] -= bbox_ref[1]
    out[:, 2] -= bbox_ref[0]
    out[:, 3] -= bbox_ref[1]
    s = [bbox_ref[2] - bbox_ref[0], bbox_ref[3] - bbox_ref[1]]
    out[:, 0] /= s[0]
    out[:, 1] /= s[1]
    out[:, 2] /= s[0]
    out[:, 3] /= s[1]
    return out


def jaccard(box: np.ndarray, boxes: np.ndarray) -> np.ndarray:
    """(ref: np_methods.py:142-160 bboxes_jaccard)."""
    ymin = np.maximum(boxes[:, 0], box[0])
    xmin = np.maximum(boxes[:, 1], box[1])
    ymax = np.minimum(boxes[:, 2], box[2])
    xmax = np.minimum(boxes[:, 3], box[3])
    inter = np.maximum(ymax - ymin, 0.0) * np.maximum(xmax - xmin, 0.0)
    union = (
        (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])
        + (box[2] - box[0]) * (box[3] - box[1])
        - inter
    )
    return np.where(union > 0, inter / np.where(union > 0, union, 1.0), 0.0)


def nms(classes, scores, boxes, nms_threshold: float = 0.45) -> Tuple:
    """Greedy class-aware NMS on score-sorted arrays
    (ref: np_methods.py:163-183 bboxes_nms): suppress only same-class
    overlaps above threshold."""
    keep = np.ones(scores.shape, dtype=bool)
    for i in range(scores.size - 1):
        if keep[i]:
            overlap = jaccard(boxes[i], boxes[i + 1:])
            mask = np.logical_and(overlap > nms_threshold, classes[i + 1:] == classes[i])
            keep[i + 1:] = np.logical_and(keep[i + 1:], ~mask)
    return classes[keep], scores[keep], boxes[keep]


def detect(
    predictions: np.ndarray,
    locations: np.ndarray,
    anchors_cyxhw: np.ndarray,
    select_threshold: float = 0.5,
    nms_threshold: float = 0.45,
    top_k: int = 400,
    bbox_img=(0.0, 0.0, 1.0, 1.0),
):
    """Full numpy demo pipeline (the notebook `process_image` cell,
    ref: notebooks/ssd_notebook.ipynb)."""
    boxes = decode_boxes(locations, anchors_cyxhw)
    classes, scores, boxes = select_boxes(predictions, boxes, select_threshold)
    boxes = clip_boxes(np.asarray(bbox_img), boxes)
    classes, scores, boxes = sort_boxes(classes, scores, boxes, top_k)
    classes, scores, boxes = nms(classes, scores, boxes, nms_threshold)
    return classes, scores, boxes
