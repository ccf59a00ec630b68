"""Box geometry on normalized (ymin, xmin, ymax, xmax) boxes, [..., 4].

Port of `ron_tensorflow_tpu/ops/boxes.py` (ref: tf_extended/bboxes.py,
nets/ssd_common.py:25-46). Leading axes broadcast: one reference box or a
batch of them against [..., N, 4] boxes.
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


def intersection_with_ref(ref_box: torch.Tensor, boxes: torch.Tensor) -> torch.Tensor:
    """The share of each box's own area inside `ref_box`, [..., 4] x
    [..., N, 4] -> [..., N], 0 for an empty box
    (ref: tf_extended/bboxes.py:536-566 `bboxes_intersection`)."""
    ref_box = ref_box[..., None, :]
    h = torch.clamp(torch.minimum(boxes[..., 2], ref_box[..., 2]) - torch.maximum(boxes[..., 0], ref_box[..., 0]),
                    min=0.0)
    w = torch.clamp(torch.minimum(boxes[..., 3], ref_box[..., 3]) - torch.maximum(boxes[..., 1], ref_box[..., 1]),
                    min=0.0)
    inter = h * w
    vol = areas(boxes)
    empty = vol == 0.0
    return torch.where(empty, 0.0, inter / torch.where(empty, 1.0, vol))


def clip_to_ref(boxes: torch.Tensor, ref_box: torch.Tensor = None) -> torch.Tensor:
    """Clip boxes to a reference box (the unit box by default), collapsing
    non-intersecting boxes to empty ones like the reference
    (ref: tf_extended/bboxes.py:124-144). `ref_box` [..., 4] broadcasts
    against boxes [..., 4]."""
    if ref_box is None:
        ymin = torch.clamp(boxes[..., 0], min=0.0)
        xmin = torch.clamp(boxes[..., 1], min=0.0)
        ymax = torch.clamp(boxes[..., 2], max=1.0)
        xmax = torch.clamp(boxes[..., 3], max=1.0)
    else:
        ref_box = torch.as_tensor(ref_box, dtype=boxes.dtype, device=boxes.device)
        ymin = torch.maximum(boxes[..., 0], ref_box[..., 0])
        xmin = torch.maximum(boxes[..., 1], ref_box[..., 1])
        ymax = torch.minimum(boxes[..., 2], ref_box[..., 2])
        xmax = torch.minimum(boxes[..., 3], ref_box[..., 3])
    ymin = torch.minimum(ymin, ymax)
    xmin = torch.minimum(xmin, xmax)
    return torch.stack([ymin, xmin, ymax, xmax], dim=-1)


def min_size_mask(boxes: torch.Tensor, min_size: float = 0.03) -> torch.Tensor:
    """Mask of boxes with height AND width > min_size
    (ref: nets/ron_vgg_320.py:196-233 `bboxes_filter_min`)."""
    h = boxes[..., 2] - boxes[..., 0]
    w = boxes[..., 3] - boxes[..., 1]
    return (w > min_size) & (h > min_size)


def resize_to_ref(ref_box: torch.Tensor, boxes: torch.Tensor) -> torch.Tensor:
    """Boxes [..., N, 4] in the frame of `ref_box` [..., 4], which maps to
    [0, 0, 1, 1]: what a crop does to them (ref: tf_extended/bboxes.py:147-171
    `bboxes_resize`)."""
    origin = torch.stack([ref_box[..., 0], ref_box[..., 1], ref_box[..., 0], ref_box[..., 1]], dim=-1)
    h = ref_box[..., 2] - ref_box[..., 0]
    w = ref_box[..., 3] - ref_box[..., 1]
    return (boxes - origin[..., None, :]) / torch.stack([h, w, h, w], dim=-1)[..., None, :]


def flip_left_right(boxes: torch.Tensor) -> torch.Tensor:
    """Normalized boxes of the horizontally flipped image
    (ref: preprocessing/tf_image.py:284-308)."""
    return torch.stack([boxes[..., 0], 1.0 - boxes[..., 3], boxes[..., 2], 1.0 - boxes[..., 1]], dim=-1)


def center_to_corner(cyxhw: torch.Tensor) -> torch.Tensor:
    """(cy, cx, h, w) -> (ymin, xmin, ymax, xmax)."""
    cy, cx, h, w = cyxhw.unbind(-1)
    return torch.stack([cy - h / 2.0, cx - w / 2.0, cy + h / 2.0, cx + w / 2.0], dim=-1)


def corner_to_center(corner: torch.Tensor) -> torch.Tensor:
    """(ymin, xmin, ymax, xmax) -> (cy, cx, h, w)."""
    ymin, xmin, ymax, xmax = corner.unbind(-1)
    return torch.stack([(ymin + ymax) / 2.0, (xmin + xmax) / 2.0, ymax - ymin, xmax - xmin], dim=-1)


def filter_center_mask(boxes: torch.Tensor, margins=(0.0, 0.0, 0.0, 0.0)) -> torch.Tensor:
    """Mask of the boxes whose centre lies inside [0, 0, 1, 1] + margins,
    with the reference's quirk kept: `cx` is tested against the upper bound
    twice and `cy` never (ref: tf_extended/bboxes.py:458-475)."""
    cy = (boxes[..., 0] + boxes[..., 2]) / 2.0
    cx = (boxes[..., 1] + boxes[..., 3]) / 2.0
    return (cy > margins[0]) & (cx > margins[1]) & (cx < 1.0 + margins[2]) & (cx < 1.0 + margins[3])


def filter_overlap_mask(boxes: torch.Tensor, valid: torch.Tensor, threshold: float = 0.5) -> torch.Tensor:
    """Mask of the valid boxes [..., N, 4] that overlap [0, 0, 1, 1] by more
    than `threshold` of their area, keeping at least the best-overlapping
    valid one(s) of each row (ref: tf_extended/bboxes.py:478-503)."""
    unit = torch.tensor([0.0, 0.0, 1.0, 1.0], dtype=boxes.dtype, device=boxes.device)
    scores = torch.where(valid, intersection_with_ref(unit, boxes), -1.0)
    best = scores.amax(dim=-1, keepdim=True)
    return ((scores > threshold) | (scores == best)) & valid
