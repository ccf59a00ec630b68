"""Box geometry on normalized (ymin, xmin, ymax, xmax) boxes, [..., 4].

Port of the parts of `ron_tensorflow_tpu/ops/boxes.py` that the detection
head uses.
"""

from __future__ import annotations

import torch


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
