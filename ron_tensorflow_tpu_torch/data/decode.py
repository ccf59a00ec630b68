"""JPEG decode for evaluation and the realtime evaluator.

Port of `decode_jpeg_raw`, `decode_jpeg` and `decode_jpeg_eval` from
`ron_tensorflow_tpu/data/pipeline.py:73-111`. OpenCV (cv2) decodes when it
is installed, else Pillow (PIL). Both are imported inside the functions:
a host without either can import this module and run everything that does
not decode a JPEG.
"""

from __future__ import annotations

import io

import numpy as np

from .preprocess import VGG_MEANS
from .resize import preprocess_for_eval


def _cv2():
    try:
        import cv2
    except ImportError:
        return None
    return cv2


def _pil_image():
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError("decoding a JPEG needs OpenCV (cv2) or Pillow (PIL); neither is installed") from e
    return Image


def decode_jpeg_raw(data: bytes) -> np.ndarray:
    """JPEG -> uint8 [H, W, 3] RGB at its original resolution."""
    cv2 = _cv2()
    if cv2 is not None:
        arr = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
        return cv2.cvtColor(arr, cv2.COLOR_BGR2RGB)
    return np.asarray(_pil_image().open(io.BytesIO(data)).convert("RGB"))


def decode_jpeg(data: bytes, out_hw) -> np.ndarray:
    """JPEG -> float32 [H, W, 3] in [0, 1], resized to out_hw by the
    library's bilinear warp (the train path's; eval uses the TF1 resize)."""
    arr = decode_jpeg_raw(data)
    cv2 = _cv2()
    if cv2 is not None:
        arr = cv2.resize(arr, (out_hw[1], out_hw[0]), interpolation=cv2.INTER_LINEAR)
    else:
        image = _pil_image()
        arr = np.asarray(image.fromarray(arr).resize((out_hw[1], out_hw[0]), image.BILINEAR))
    return arr.astype(np.float32) / 255.0


def decode_jpeg_eval(data: bytes, out_hw, strategy: str) -> np.ndarray:
    """JPEG -> uint8 [out_h, out_w, 3] canvas by an eval resize strategy
    with TF1 legacy bilinear numerics (pad fill = VGG mean = whitened 0)."""
    raw = decode_jpeg_raw(data)
    whitened, _, _ = preprocess_for_eval(raw, np.zeros((0, 4), np.float32), strategy, out_hw)
    pixels = whitened + np.asarray(VGG_MEANS, np.float32)
    return np.clip(pixels + 0.5, 0.0, 255.0).astype(np.uint8)
