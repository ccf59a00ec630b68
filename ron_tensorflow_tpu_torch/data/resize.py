"""TF1 legacy bilinear resize and the four eval resize strategies.

Port of `ron_tensorflow_tpu/data/resize.py`. The published reference
checkpoints were trained and evaluated with TF1's legacy bilinear kernel:
align_corners=False, half_pixel_centers=False, no antialiasing;
src = dst * (in/out), edge-clamped, lerp x then y
(ref: preprocessing/tf_image.py:269-281 `resize_image`).

Eval strategies (ref: preprocessing/ssd_vgg_preprocessing.py:358-425),
host-side numpy as in the JAX package:
  NONE           no resize (variable shapes; realtime/batch-1 only);
  CENTRAL_CROP   central crop-or-pad to out_shape with box remap
                 (ref: preprocessing/tf_image.py:141-266);
  PAD_AND_RESIZE downscale by min(1, out/in), then central pad;
  WARP_RESIZE    plain bilinear warp (the default).
Padding fills with the VGG mean colour, which is exactly 0 in whitened
space: the reference pads after whitening, with zeros.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

EVAL_RESIZE_STRATEGIES = ("NONE", "CENTRAL_CROP", "PAD_AND_RESIZE", "WARP_RESIZE")


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


def _crop_or_pad_boxes(boxes, src_hw, offset_yx, dst_hw):
    """One crop-or-pad stage of box remapping
    (ref: preprocessing/tf_image.py:141-166 `bboxes_crop_or_pad`)."""
    sh, sw = src_hw
    oy, ox = offset_yx
    dh, dw = dst_hw
    scale = np.array([sh, sw, sh, sw], np.float32)
    offset = np.array([oy, ox, oy, ox], np.float32)
    rescale = np.array([dh, dw, dh, dw], np.float32)
    return (boxes * scale + offset) / rescale


def central_crop_or_pad(image, boxes, target_hw: Tuple[int, int], fill=0.0):
    """Central crop and/or pad to target, remapping normalized boxes
    (ref: preprocessing/tf_image.py:169-266). Numpy.

    Returns (image [th, tw, C] float32, boxes remapped, not clipped, as the
    reference leaves them)."""
    h, w = image.shape[:2]
    th, tw = target_hw
    och, ocw = max(-(th - h) // 2, 0), max(-(tw - w) // 2, 0)
    oph, opw = max((th - h) // 2, 0), max((tw - w) // 2, 0)
    hc, wc = min(th, h), min(tw, w)

    cropped = image[och : och + hc, ocw : ocw + wc].astype(np.float32)
    boxes = _crop_or_pad_boxes(boxes, (h, w), (-och, -ocw), (hc, wc))

    out = np.full((th, tw) + image.shape[2:], fill, np.float32)
    out[oph : oph + hc, opw : opw + wc] = cropped
    boxes = _crop_or_pad_boxes(boxes, (hc, wc), (oph, opw), (th, tw))
    return out, boxes


def remap_boxes_for_eval(
    boxes: np.ndarray,
    orig_hw: Tuple[int, int],
    resize: str,
    out_shape: Tuple[int, int] = (320, 320),
) -> np.ndarray:
    """Box-only remap for a resize strategy: the geometry of
    `preprocess_for_eval` without the pixels. NONE and WARP_RESIZE leave
    normalized boxes unchanged."""
    if resize not in EVAL_RESIZE_STRATEGIES:
        raise ValueError(f"unknown resize strategy {resize!r}")
    boxes = np.asarray(boxes, np.float32).reshape(-1, 4)
    if resize in ("NONE", "WARP_RESIZE") or boxes.size == 0:
        return boxes
    h, w = orig_hw
    if resize == "PAD_AND_RESIZE":
        factor = min(1.0, min(out_shape[0] / h, out_shape[1] / w))
        h, w = int(np.floor(factor * h)), int(np.floor(factor * w))
    th, tw = out_shape
    och, ocw = max(-(th - h) // 2, 0), max(-(tw - w) // 2, 0)
    oph, opw = max((th - h) // 2, 0), max((tw - w) // 2, 0)
    hc, wc = min(th, h), min(tw, w)
    boxes = _crop_or_pad_boxes(boxes, (h, w), (-och, -ocw), (hc, wc))
    return _crop_or_pad_boxes(boxes, (hc, wc), (oph, opw), (th, tw))


def preprocess_for_eval(
    image_uint8: np.ndarray,
    boxes: np.ndarray,
    resize: str = "WARP_RESIZE",
    out_shape: Tuple[int, int] = (320, 320),
):
    """Whiten + resize strategy, the reference's `preprocess_for_eval`
    (ref: ssd_vgg_preprocessing.py:358-425). Numpy.

    image_uint8 [H, W, 3] RGB; boxes [G, 4] normalized (ymin, xmin, ymax,
    xmax), may be empty. Returns (whitened float32 image [oh, ow, 3], the
    original size for NONE; the boxes remapped, same count and order, not
    clipped; bbox_img [4], the original image rectangle in the output
    frame, which un-resizes detections)."""
    from .preprocess import VGG_MEANS  # preprocess imports this module

    if resize not in EVAL_RESIZE_STRATEGIES:
        raise ValueError(f"unknown resize strategy {resize!r}")
    img = image_uint8.astype(np.float32) - np.asarray(VGG_MEANS, np.float32)
    boxes = np.asarray(boxes, np.float32).reshape(-1, 4)
    # the image rectangle rides through the same remap as the gt boxes
    # (ref: ssd_vgg_preprocessing.py:380-384, 415-417)
    stacked = np.concatenate([np.array([[0.0, 0.0, 1.0, 1.0]], np.float32), boxes], 0)

    if resize == "NONE":
        out = img
    elif resize == "CENTRAL_CROP":
        out, stacked = central_crop_or_pad(img, stacked, out_shape)
    elif resize == "PAD_AND_RESIZE":
        h, w = img.shape[:2]
        factor = min(1.0, min(out_shape[0] / h, out_shape[1] / w))  # float64
        resize_hw = (int(np.floor(factor * h)), int(np.floor(factor * w)))
        out = tf1_bilinear_resize(img, resize_hw)
        out, stacked = central_crop_or_pad(out, stacked, out_shape)
    else:  # WARP_RESIZE
        out = tf1_bilinear_resize(img, out_shape)

    return out, stacked[1:], stacked[0]
