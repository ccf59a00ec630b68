"""Box geometry on normalized (ymin, xmin, ymax, xmax) boxes, [..., 4].

Port of the parts of `ron_tensorflow_tpu/ops/boxes.py` that the detection
heads, the matcher and the target encoder use.
"""

from __future__ import annotations

import torch


def areas(boxes: torch.Tensor) -> torch.Tensor:
    """Box areas, [..., 4] -> [...] (ref: nets/ssd_common.py:25-27)."""
    h = boxes[..., 2] - boxes[..., 0]
    w = boxes[..., 3] - boxes[..., 1]
    return h * w


def intersection(boxes_a: torch.Tensor, boxes_b: torch.Tensor) -> torch.Tensor:
    """Pairwise intersection areas, [..., A, 4] x [..., B, 4] -> [..., A, B]
    (ref: nets/ssd_common.py:28-39)."""
    a, b = boxes_a[..., :, None, :], boxes_b[..., None, :, :]
    h = torch.clamp(torch.minimum(a[..., 2], b[..., 2]) - torch.maximum(a[..., 0], b[..., 0]), min=0.0)
    w = torch.clamp(torch.minimum(a[..., 3], b[..., 3]) - torch.maximum(a[..., 1], b[..., 1]), min=0.0)
    return h * w


def iou_matrix(boxes_a: torch.Tensor, boxes_b: torch.Tensor) -> torch.Tensor:
    """Pairwise IoU, [..., A, 4] x [..., B, 4] -> [..., A, B], 0 where the
    union is empty (ref: nets/ssd_common.py:40-46).

    The union adds b's area to a's with one rounding, h_b * w_b + area_a as
    a fused multiply-add (here exact in float64, then rounded), which is how
    XLA computes the JAX encoder's fused IoU: with two roundings an IoU
    within an ulp of a match threshold can fall on the other side of it."""
    inter = intersection(boxes_a, boxes_b)
    hb = (boxes_b[..., 2] - boxes_b[..., 0]).double()
    wb = (boxes_b[..., 3] - boxes_b[..., 1]).double()
    union = (areas(boxes_a).double()[..., :, None] + (hb * wb)[..., None, :]).to(inter.dtype) - inter
    empty = union == 0.0
    return torch.where(empty, 0.0, inter / torch.where(empty, 1.0, union))


def jaccard_one_to_many(box: torch.Tensor, boxes: torch.Tensor) -> torch.Tensor:
    """IoU of box [..., 4] against boxes [..., N, 4] -> [..., N] (leading
    axes broadcast), 0 where the union is 0: the guarded divide of
    `bboxes_jaccard` (ref: tf_extended/bboxes.py:511-533)."""
    box = box[..., None, :]
    ymin = torch.maximum(boxes[..., 0], box[..., 0])
    xmin = torch.maximum(boxes[..., 1], box[..., 1])
    ymax = torch.minimum(boxes[..., 2], box[..., 2])
    xmax = torch.minimum(boxes[..., 3], box[..., 3])
    h = torch.clamp(ymax - ymin, min=0.0)
    w = torch.clamp(xmax - xmin, min=0.0)
    inter = h * w
    union = areas(boxes) + areas(box) - inter
    empty = union == 0.0
    return torch.where(empty, 0.0, inter / torch.where(empty, 1.0, union))


def clip_to_ref(boxes: torch.Tensor) -> torch.Tensor:
    """Clip boxes to the unit box, collapsing non-intersecting boxes to
    empty ones like the reference (ref: tf_extended/bboxes.py:124-144)."""
    ymin = torch.clamp(boxes[..., 0], min=0.0)
    xmin = torch.clamp(boxes[..., 1], min=0.0)
    ymax = torch.clamp(boxes[..., 2], max=1.0)
    xmax = torch.clamp(boxes[..., 3], max=1.0)
    ymin = torch.minimum(ymin, ymax)
    xmin = torch.minimum(xmin, xmax)
    return torch.stack([ymin, xmin, ymax, xmax], dim=-1)


def min_size_mask(boxes: torch.Tensor, min_size: float = 0.03) -> torch.Tensor:
    """Mask of boxes with height AND width > min_size
    (ref: nets/ron_vgg_320.py:196-233 `bboxes_filter_min`)."""
    h = boxes[..., 2] - boxes[..., 0]
    w = boxes[..., 3] - boxes[..., 1]
    return (w > min_size) & (h > min_size)
