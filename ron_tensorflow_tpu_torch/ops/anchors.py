"""Anchor (prior box) generation (numpy only).

A copy of `ron_tensorflow_tpu/ops/anchors.py`, kept here so the port
imports nothing of the JAX package. Replacement for the reference's per-layer numpy anchor grids
(ref: nets/ron_vgg_320.py:285-355 `ron_anchor_one_layer` /
`ron_anchors_all_layers`; SSD variant nets/ssd_vgg_300.py:306-380).

Anchors are graph constants: we precompute one flat `[N, 4]` array in
`(cy, cx, h, w)` order covering *all* feature layers jointly — the layout
required by the reference's all-layers-joint ground-truth matching fix
(ref: nets/ssd_common.py:363-414, README.md:25). Flattening order per layer
is row-major `(y, x, anchor)` with `anchor = i_ratio * len(sizes) + j_size`
(ref: nets/ron_vgg_320.py:330-333), layers ordered as configured
(RON: block7→block6→block5→block4, i.e. coarse→fine).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class AnchorLayout:
    """Flat anchors for every feature layer of a detector, plus the
    bookkeeping needed to split per-layer views back out."""

    # [N, 4] (cy, cx, h, w), normalized to the image. float32 numpy.
    cyxhw: np.ndarray
    # [N, 4] (ymin, xmin, ymax, xmax) corner form.
    corners: np.ndarray
    # [N] per-anchor allowed border in pixels (ref: RONParams.allowed_borders).
    allowed_borders: np.ndarray
    # Per-layer (H, W, A) shapes in layer order.
    layer_shapes: Tuple[Tuple[int, int, int], ...]

    @property
    def num_anchors(self) -> int:
        return self.cyxhw.shape[0]

    @property
    def layer_sizes(self) -> Tuple[int, ...]:
        return tuple(h * w * a for (h, w, a) in self.layer_shapes)

    def split_layers(self, flat: np.ndarray):
        """Split a [N, ...] array into per-layer [H, W, A, ...] views."""
        out = []
        start = 0
        for (h, w, a) in self.layer_shapes:
            n = h * w * a
            out.append(flat[start : start + n].reshape((h, w, a) + flat.shape[1:]))
            start += n
        return out


def anchor_heights_widths(
    img_shape: Tuple[int, int], sizes: Sequence[float], ratios: Sequence[float]
) -> Tuple[np.ndarray, np.ndarray]:
    """Per-cell anchor heights/widths, normalized.

    Ordering follows the original RON implementation:
    `h[i * len(sizes) + j] = sizes[j] / img_h / sqrt(ratios[i])`
    (ref: nets/ron_vgg_320.py:325-333).
    """
    num = len(sizes) * len(ratios)
    h = np.zeros((num,), dtype=np.float32)
    w = np.zeros((num,), dtype=np.float32)
    for i, r in enumerate(ratios):
        for j, s in enumerate(sizes):
            h[i * len(sizes) + j] = s / img_shape[0] / math.sqrt(r)
            w[i * len(sizes) + j] = s / img_shape[1] * math.sqrt(r)
    return h, w


def ssd_anchor_heights_widths(
    img_shape: Tuple[int, int], sizes: Sequence[float], ratios: Sequence[float]
) -> Tuple[np.ndarray, np.ndarray]:
    """SSD-style per-cell anchors (ref: nets/ssd_vgg_300.py:344-359):
    anchor 0 = square sizes[0]; anchor 1 = square sqrt(sizes[0]*sizes[1]);
    then one anchor per ratio applied to sizes[0]. num = len(sizes)+len(ratios).
    """
    num = len(sizes) + len(ratios)
    h = np.zeros((num,), dtype=np.float32)
    w = np.zeros((num,), dtype=np.float32)
    h[0] = sizes[0] / img_shape[0]
    w[0] = sizes[0] / img_shape[1]
    di = 1
    if len(sizes) > 1:
        h[1] = math.sqrt(sizes[0] * sizes[1]) / img_shape[0]
        w[1] = math.sqrt(sizes[0] * sizes[1]) / img_shape[1]
        di += 1
    for i, r in enumerate(ratios):
        h[i + di] = sizes[0] / img_shape[0] / math.sqrt(r)
        w[i + di] = sizes[0] / img_shape[1] * math.sqrt(r)
    return h, w


def anchors_one_layer(
    img_shape: Tuple[int, int],
    feat_shape: Tuple[int, int],
    sizes: Sequence[float],
    ratios: Sequence[float],
    step: float,
    offset: float = 0.5,
    style: str = "ron",
):
    """Anchor grid for one layer, in the reference's (y, x, h, w) form:
    y, x: [H, W, 1]; h, w: [A]. Centers are `((idx + offset) * step) / img`
    (ref: nets/ron_vgg_320.py:316-320). `style` picks the per-cell anchor
    family: 'ron' (sizes x ratios grid) or 'ssd' (sizes[0]-based + ratios).
    """
    y, x = np.mgrid[0 : feat_shape[0], 0 : feat_shape[1]]
    y = ((y.astype(np.float32) + offset) * step) / img_shape[0]
    x = ((x.astype(np.float32) + offset) * step) / img_shape[1]
    y = y[..., None]
    x = x[..., None]
    if style == "ron":
        h, w = anchor_heights_widths(img_shape, sizes, ratios)
    elif style == "ssd":
        h, w = ssd_anchor_heights_widths(img_shape, sizes, ratios)
    else:
        raise ValueError(f"unknown anchor style {style!r}")
    return y, x, h, w


def build_anchor_layout(
    img_shape: Tuple[int, int],
    feat_shapes: Sequence[Tuple[int, int]],
    anchor_sizes: Sequence[Sequence[float]],
    anchor_ratios: Sequence[Sequence[float]],
    anchor_steps: Sequence[float],
    allowed_borders: Sequence[float],
    offset: float = 0.5,
    style: str = "ron",
) -> AnchorLayout:
    """Build the joint flat anchor layout for all layers.

    Equivalent to the reference's anchor concat inside the encoder
    (ref: nets/ssd_common.py:369-404), hoisted out as a reusable constant.
    """
    all_cyxhw = []
    all_borders = []
    layer_shapes = []
    for i, feat_shape in enumerate(feat_shapes):
        y, x, h, w = anchors_one_layer(
            img_shape, feat_shape, anchor_sizes[i], anchor_ratios[i], anchor_steps[i], offset, style
        )
        a = h.shape[0]
        hh, ww = feat_shape
        # Corner→center→corner float32 roundtrip, exactly like the reference's
        # joint encoder (ref: nets/ssd_common.py:372-383 then :103-110): the
        # re-derived h is e.g. 0.8000001, not 0.8, and the re-derived corner
        # -0.10000002 *fails* the >= -0.1 border test that the direct corner
        # -0.09999999 passes. Bit-exact parity of the inside mask (and hence
        # of anchor matching) requires reproducing this rounding.
        ymin = (y - h / 2.0).astype(np.float32)
        xmin = (x - w / 2.0).astype(np.float32)
        ymax = (y + h / 2.0).astype(np.float32)
        xmax = (x + w / 2.0).astype(np.float32)
        cyxhw = np.stack(
            [
                np.broadcast_to((ymin + ymax) / 2.0, (hh, ww, a)),
                np.broadcast_to((xmin + xmax) / 2.0, (hh, ww, a)),
                np.broadcast_to(ymax - ymin, (hh, ww, a)),
                np.broadcast_to(xmax - xmin, (hh, ww, a)),
            ],
            axis=-1,
        ).reshape(-1, 4)
        all_cyxhw.append(cyxhw.astype(np.float32))
        all_borders.append(np.full((hh * ww * a,), allowed_borders[i], dtype=np.float32))
        layer_shapes.append((hh, ww, a))

    cyxhw = np.concatenate(all_cyxhw, axis=0)
    borders = np.concatenate(all_borders, axis=0)
    cy, cx, h, w = cyxhw[:, 0], cyxhw[:, 1], cyxhw[:, 2], cyxhw[:, 3]
    corners = np.stack(
        [cy - h / 2.0, cx - w / 2.0, cy + h / 2.0, cx + w / 2.0], axis=-1
    ).astype(np.float32)
    return AnchorLayout(
        cyxhw=cyxhw,
        corners=corners,
        allowed_borders=borders,
        layer_shapes=tuple(layer_shapes),
    )
