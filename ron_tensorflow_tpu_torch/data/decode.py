"""JPEG decode for the input pipeline, evaluation and the realtime evaluator.

Port of `decode_jpeg_raw`, `decode_jpeg` and `decode_jpeg_eval` from
`ron_tensorflow_tpu/data/pipeline.py:73-111`. The JAX package decodes
through OpenCV (cv2), else Pillow (PIL); the port decodes and resizes with
its own decoder (`data/jpeg.py`), bit for bit what cv2 gives (libjpeg-
turbo's decode, cv2.resize INTER_LINEAR) on baseline JPEGs. Frames it does
not take (progressive, arithmetic-coded, 12-bit, CMYK) raise ValueError.
"""

from __future__ import annotations

import numpy as np

from . import jpeg
from .preprocess import VGG_MEANS
from .resize import preprocess_for_eval


def decode_jpeg_raw(data: bytes) -> np.ndarray:
    """JPEG -> uint8 [H, W, 3] RGB at its original resolution."""
    return jpeg.decode_rgb(data)


def decode_jpeg(data: bytes, out_hw) -> np.ndarray:
    """JPEG -> float32 [H, W, 3] in [0, 1], resized to out_hw by cv2's
    bilinear warp (the train path's; eval uses the TF1 resize)."""
    return jpeg.resize_bilinear(jpeg.decode_rgb(data), out_hw).astype(np.float32) / 255.0


def decode_jpeg_eval(data: bytes, out_hw, strategy: str) -> np.ndarray:
    """JPEG -> uint8 [out_h, out_w, 3] canvas by an eval resize strategy
    with TF1 legacy bilinear numerics (pad fill = VGG mean = whitened 0)."""
    raw = decode_jpeg_raw(data)
    whitened, _, _ = preprocess_for_eval(raw, np.zeros((0, 4), np.float32), strategy, out_hw)
    pixels = whitened + np.asarray(VGG_MEANS, np.float32)
    return np.clip(pixels + 0.5, 0.0, 255.0).astype(np.uint8)
