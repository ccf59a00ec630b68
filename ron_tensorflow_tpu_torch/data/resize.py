"""TF1 legacy bilinear resize.

Port of `ron_tensorflow_tpu/data/resize.py::tf1_bilinear_resize`. The
published reference checkpoints were trained and evaluated with TF1's
legacy bilinear kernel: align_corners=False, half_pixel_centers=False, no
antialiasing; src = dst * (in/out), edge-clamped, lerp x then y
(ref: preprocessing/tf_image.py:269-281 `resize_image`).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def _axis_plan(in_size: int, out_size: int):
    """Legacy TF1 sampling plan for one axis: lower/upper indices + lerp
    fraction, float32 like the TF kernel."""
    scale = np.float32(in_size) / np.float32(out_size)
    src = np.arange(out_size, dtype=np.float32) * scale
    i0 = np.floor(src).astype(np.int64)
    frac = src - i0
    i1 = np.minimum(i0 + 1, in_size - 1)
    return i0, i1, frac


def tf1_bilinear_resize(image, out_shape: Tuple[int, int]):
    """Bilinear resize with TF1 legacy semantics, float32 output. Takes a
    numpy array (returns numpy) or a tensor (returns a tensor on its device).

    image: [H, W, C] -> [out_h, out_w, C].
    """
    is_tensor = torch.is_tensor(image)
    img = image.float() if is_tensor else np.asarray(image).astype(np.float32)
    h, w = int(img.shape[0]), int(img.shape[1])
    oh, ow = out_shape
    if (h, w) == (oh, ow):
        return img
    y0, y1, fy = _axis_plan(h, oh)
    x0, x1, fx = _axis_plan(w, ow)
    if is_tensor:
        y0, y1, fy, x0, x1, fx = (torch.as_tensor(a, device=img.device) for a in (y0, y1, fy, x0, x1, fx))
    # Exactly the TF kernel's arithmetic: a + (b - a) * lerp, x first, then y.
    left = img[:, x0]
    rows = left + (img[:, x1] - left) * fx[None, :, None]
    top = rows[y0]
    return top + (rows[y1] - top) * fy[:, None, None]
