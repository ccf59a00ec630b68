"""The synthetic detection dataset of the learning check
(`tools/synthetic_e2e.py`): six classes of solid shapes on noise, written
as VOC TFRecord shards.

A port of `make_dataset` in `tools/synthetic_e2e.py` without PIL. Each
image is a `canvas` x `canvas` noise background (uint8 in [0, 80)) with one
or two objects: classes 1-3 are rectangles, classes 4-6 ellipses, each
class its own colour. The random draws come in the JAX tool's order (the
background, the object count, then per object the class, w and h, x0, y0),
so that the same seed gives the same backgrounds, boxes and labels.

The shapes are drawn with numpy as Pillow's `ImageDraw` fills them: a
rectangle covers the pixels from the truncated corners to the truncated
far corners, both included; an ellipse covers the pixels whose centres lie
inside the ellipse inscribed in its truncated box's pixels (Pillow's own
rasterizer differs on a few edge pixels of each ellipse); a polygon
(`fill_polygon`, the dress rehearsal's triangles) is Pillow's scanline
fill of its truncated vertices. The images are
JPEG-encoded at quality 90 by the port's encoder (`data.jpeg.encode_jpeg`,
byte for byte what Pillow writes for the same pixels) and written through
`data/convert.py::encode_voc_example` into `synth_train_000.tfrecord` and
`synth_test_000.tfrecord`.
"""

from __future__ import annotations

import os

import numpy as np

from ..data.convert import encode_voc_example
from ..data.jpeg import encode_jpeg
from ..data.tfrecord import TFRecordWriter
from ..data.voc import VocAnnotation, VocObject

COLORS = [(230, 40, 40), (40, 230, 40), (40, 40, 230), (230, 230, 40), (230, 40, 230), (40, 230, 230)]


def fill_rectangle(img: np.ndarray, box, color) -> None:
    """`ImageDraw.rectangle(box, fill=color)` on an [H, W, 3] array."""
    x0, y0, x1, y1 = (int(v) for v in box)
    img[y0: y1 + 1, x0: x1 + 1] = color


def fill_ellipse(img: np.ndarray, box, color) -> None:
    """`ImageDraw.ellipse(box, fill=color)` on an [H, W, 3] array, up to a
    few edge pixels."""
    x0, y0, x1, y1 = (int(v) for v in box)
    a, b = x1 - x0 + 1, y1 - y0 + 1  # the box's pixels, both ends included
    r0, c0 = max(y0, 0), max(x0, 0)  # no pixel outside the box is inside
    yy, xx = np.ogrid[r0: min(y1 + 1, img.shape[0]), c0: min(x1 + 1, img.shape[1])]
    inside = ((xx + 0.5 - x0 - a / 2) / (a / 2)) ** 2 + ((yy + 0.5 - y0 - b / 2) / (b / 2)) ** 2 <= 1.0
    img[r0: r0 + inside.shape[0], c0: c0 + inside.shape[1]][inside] = color


def _round_half_up(f: np.float32) -> int:
    """Pillow's ROUND_UP: halves away from zero."""
    return int(np.floor(f + np.float32(0.5))) if f >= 0 else -int(np.floor(abs(f) + np.float32(0.5)))


def _round_half_down(f: np.float32) -> int:
    """Pillow's ROUND_DOWN: halves towards zero."""
    return int(np.ceil(f - np.float32(0.5))) if f >= 0 else -int(np.ceil(abs(f) - np.float32(0.5)))


def fill_polygon(img: np.ndarray, points, color) -> None:
    """`ImageDraw.polygon(points, fill=color)` on an [H, W, 3] array:
    Pillow's scanline fill (`polygon_generic` in its draw.c) of the
    truncated vertices, in float32 as Pillow computes it. Each row y meets
    every edge that spans it at x0 + (y - y0) * dx, an edge's last row
    counting twice below the polygon's last row; sorted crossings pair
    into runs from ROUND_UP(left) to ROUND_DOWN(right); horizontal edges
    are drawn whole. Pillow's rule for corners where two edges that run the
    same way in x meet on a whole-pixel crossing is not reproduced: a
    triangle never has one (its two slanted edges run opposite ways)."""
    xy = [(int(x), int(y)) for x, y in points]
    h, w = img.shape[:2]
    edges, top, bottom = [], h - 1, 0
    for (xa, ya), (xb, yb) in zip(xy, xy[1:] + xy[:1]):
        if (xa, ya) == (xb, yb):
            continue
        lo, hi = min(ya, yb), max(ya, yb)
        top, bottom = min(top, lo), max(bottom, hi)
        if ya == yb:
            if 0 <= ya < h:
                img[ya, max(min(xa, xb), 0): min(max(xa, xb), w - 1) + 1] = color
            continue
        edges.append((lo, hi, xa, ya, np.float32(xb - xa) / np.float32(yb - ya)))
    for y in range(max(top, 0), min(bottom, h - 1) + 1):
        xx = []
        for lo, hi, xa, ya, dx in edges:
            if lo <= y <= hi:
                xx.append(np.float32(y - ya) * dx + np.float32(xa))
                if y == hi and y < bottom:
                    xx.append(xx[-1])
        xx.sort()
        for left, right in zip(xx[0::2], xx[1::2]):
            start, end = _round_half_up(left), _round_half_down(right)
            if end >= start:
                img[y, max(start, 0): min(end, w - 1) + 1] = color


def draw_sample(rng: np.random.Generator, canvas: int):
    """One image (uint8 [canvas, canvas, 3]) and its annotation."""
    img = rng.integers(0, 80, (canvas, canvas, 3), np.uint8)
    objects = []
    for _ in range(1 + int(rng.integers(0, 2))):
        cls = 1 + int(rng.integers(0, 6))
        w, h = rng.uniform(0.25, 0.55, 2) * canvas
        x0 = rng.uniform(0, canvas - w)
        y0 = rng.uniform(0, canvas - h)
        box = (x0, y0, x0 + w, y0 + h)
        (fill_rectangle if cls <= 3 else fill_ellipse)(img, box, COLORS[cls - 1])
        objects.append(VocObject(cls, f"class{cls}", (y0 / canvas, x0 / canvas, (y0 + h) / canvas, (x0 + w) / canvas),
                                 0, 0))
    return img, VocAnnotation((canvas, canvas, 3), objects)


def make_dataset(out_dir: str, n_train=800, n_test=96, seed=0, canvas=128) -> str:
    """Write `synth_train_000.tfrecord` (n_train images) and
    `synth_test_000.tfrecord` (n_test) under out_dir; returns out_dir."""
    rng = np.random.default_rng(seed)
    os.makedirs(out_dir, exist_ok=True)
    for split, n in (("train", n_train), ("test", n_test)):
        with TFRecordWriter(os.path.join(out_dir, f"synth_{split}_000.tfrecord")) as w:
            for _ in range(n):
                img, ann = draw_sample(rng, canvas)
                w.write(encode_voc_example(encode_jpeg(img, quality=90), ann))
    return out_dir

