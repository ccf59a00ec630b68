"""Box decoding, the inverse of the target transform.

Port of `ron_tensorflow_tpu/ops/decode.py`. Localization predictions use
SSD (cx, cy, w, h) channel order.
"""

from __future__ import annotations

from typing import Sequence

import torch


def decode_boxes(
    locations: torch.Tensor,
    anchors_cyxhw: torch.Tensor,
    prior_scaling: Sequence[float] = (0.1, 0.1, 0.2, 0.2),
) -> torch.Tensor:
    """locations [..., N, 4] offsets (cx, cy, w, h), anchors [N, 4]
    (cy, cx, h, w) -> [..., N, 4] corner boxes (ymin, xmin, ymax, xmax),
    not clipped."""
    acy, acx, ah, aw = anchors_cyxhw.unbind(-1)
    s0, s1, s2, s3 = prior_scaling
    cx = locations[..., 0] * aw * s0 + acx
    cy = locations[..., 1] * ah * s1 + acy
    w = aw * torch.exp(locations[..., 2] * s2)
    h = ah * torch.exp(locations[..., 3] * s3)
    return torch.stack([cy - h / 2.0, cx - w / 2.0, cy + h / 2.0, cx + w / 2.0], dim=-1)
