"""The benchmark's traffic: crowded 21-class shape scenes drawn from a seed.

A copy of the drawing of the port's dress rehearsal
(`tools/dress_rehearsal.py::gen_sample`, crowded mode), the scenes the
repository's trained RON-320 learned: a dark noisy background, 1-48
objects an image (55% 1-5, 35% 6-18, 10% 19-48), same-class clusters of
3-5 overlapping objects, tiny objects down to 4% of a side. Class k is
(shape, colour) combination k. The parameters come from the traffic file
(`objects`, `cluster`, `min_side`, `max_side`), and the scenes are drawn
straight at the model's input size, with the shapes filled by numpy masks
(Pillow's scanline rules are not reproduced: no JPEG round trip either).

Every seed draws the same number of images at the same size; what changes
with the seed is what they show.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

SHAPES = ("rect", "ellipse", "triangle", "bar", "ring")
COLORS = ((235, 45, 45), (45, 235, 45), (65, 65, 245), (235, 235, 45))
RING_HOLE = (40, 40, 40)
VGG_MEANS = (123.0, 117.0, 104.0)  # the published whitening (ssd_vgg_preprocessing.py)


def _grid(img, box):
    """Pixel centres inside box (x0, y0, x1, y1), and the slices they index."""
    h, w = img.shape[:2]
    x0, y0, x1, y1 = box
    r0, r1 = max(int(np.floor(y0)), 0), min(int(np.ceil(y1)) + 1, h)
    c0, c1 = max(int(np.floor(x0)), 0), min(int(np.ceil(x1)) + 1, w)
    yy, xx = np.mgrid[r0:r1, c0:c1].astype(np.float32)
    return yy + 0.5, xx + 0.5, (slice(r0, r1), slice(c0, c1))


def _ellipse(img, box, color):
    x0, y0, x1, y1 = box
    yy, xx, sl = _grid(img, box)
    ry, rx = max((y1 - y0) / 2.0, 0.5), max((x1 - x0) / 2.0, 0.5)
    mask = ((yy - (y0 + y1) / 2.0) / ry) ** 2 + ((xx - (x0 + x1) / 2.0) / rx) ** 2 <= 1.0
    img[sl][mask] = color


def _rect(img, box, color):
    yy, xx, sl = _grid(img, box)
    x0, y0, x1, y1 = box
    img[sl][(yy >= y0) & (yy <= y1) & (xx >= x0) & (xx <= x1)] = color


def _triangle(img, box, color):
    """Apex at the top centre, base along the bottom edge."""
    x0, y0, x1, y1 = box
    yy, xx, sl = _grid(img, box)
    half = (x1 - x0) / 2.0 * (yy - y0) / max(y1 - y0, 1e-6)
    img[sl][(yy >= y0) & (yy <= y1) & (np.abs(xx - (x0 + x1) / 2.0) <= half)] = color


def draw_object(img: np.ndarray, cls: int, box) -> None:
    """Class `cls` (1..20) in `box` (x0, y0, x1, y1) on an [H, W, 3] uint8 array."""
    shape, color = SHAPES[(cls - 1) % 5], COLORS[(cls - 1) // 5]
    x0, y0, x1, y1 = box
    if shape == "rect":
        _rect(img, box, color)
    elif shape == "ellipse":
        _ellipse(img, box, color)
    elif shape == "triangle":
        _triangle(img, box, color)
    elif shape == "bar":
        h = y1 - y0
        _rect(img, (x0, y0 + 0.35 * h, x1, y1 - 0.35 * h), color)
    else:
        _ellipse(img, box, color)
        w, h = x1 - x0, y1 - y0
        _ellipse(img, (x0 + 0.3 * w, y0 + 0.3 * h, x1 - 0.3 * w, y1 - 0.3 * h), RING_HOLE)


def n_objects(rng: np.random.Generator, objects: List[list]) -> int:
    """`objects`: [[share, low, high], ...] bands of the count, inclusive."""
    u, acc = rng.uniform(), 0.0
    for share, low, high in objects:
        acc += share
        if u < acc:
            return low + int(rng.integers(0, high - low + 1))
    return objects[-1][1]


def draw_scene(rng: np.random.Generator, h: int, w: int, traffic: dict) -> Tuple[np.ndarray, list]:
    """One scene -> (uint8 [h, w, 3], [(label, (ymin, xmin, ymax, xmax)) normalized])."""
    img = (rng.integers(0, 70, (h, w, 3)) + rng.integers(0, 40)).astype(np.uint8)
    objects, n, i = [], n_objects(rng, traffic["objects"]), 0
    lo, hi = traffic["min_side"], traffic["max_side"]
    cluster = traffic["cluster"]
    while i < n:
        cls = 1 + int(rng.integers(0, 20))
        if n - i >= 3 and rng.uniform() < cluster["share"]:
            k = min(cluster["min"] + int(rng.integers(0, cluster["max"] - cluster["min"] + 1)), n - i)
            s = rng.uniform(*cluster["side"])
            cyc, cxc = rng.uniform(s, 1 - s), rng.uniform(s, 1 - s)
            for _ in range(k):
                ow, oh = s * rng.uniform(0.8, 1.2) * w, s * rng.uniform(0.8, 1.2) * h
                x0 = float(np.clip(cxc * w + rng.uniform(-0.6, 0.6) * ow - ow / 2, 0, w - ow))
                y0 = float(np.clip(cyc * h + rng.uniform(-0.6, 0.6) * oh - oh / 2, 0, h - oh))
                draw_object(img, cls, (x0, y0, x0 + ow, y0 + oh))
                objects.append((cls, (y0 / h, x0 / w, (y0 + oh) / h, (x0 + ow) / w)))
                i += 1
            continue
        ow, oh = rng.uniform(lo, hi) * w, rng.uniform(lo, hi) * h
        x0, y0 = rng.uniform(0, w - ow), rng.uniform(0, h - oh)
        draw_object(img, cls, (x0, y0, x0 + ow, y0 + oh))
        objects.append((cls, (y0 / h, x0 / w, (y0 + oh) / h, (x0 + ow) / w)))
        i += 1
    return img, objects


def whiten(images_u8: np.ndarray) -> np.ndarray:
    """uint8 pixels -> float32 pixels less the VGG means, as the port's input."""
    return images_u8.astype(np.float32) - np.asarray(VGG_MEANS, np.float32)


def draw_pool(seed: int, n: int, h: int, w: int, traffic: dict) -> Tuple[np.ndarray, list]:
    """`n` scenes of seed `seed` -> (uint8 [n, h, w, 3], their objects)."""
    rng = np.random.default_rng(seed)
    images = np.empty((n, h, w, 3), np.uint8)
    objects = []
    for j in range(n):
        images[j], obj = draw_scene(rng, h, w, traffic)
        objects.append(obj)
    return images, objects
