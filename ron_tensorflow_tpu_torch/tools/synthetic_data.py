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
rasterizer differs on a few edge pixels of each ellipse). The images are
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
    yy, xx = np.ogrid[0: img.shape[0], 0: img.shape[1]]
    inside = ((xx + 0.5 - x0 - a / 2) / (a / 2)) ** 2 + ((yy + 0.5 - y0 - b / 2) / (b / 2)) ** 2 <= 1.0
    img[inside] = color


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

