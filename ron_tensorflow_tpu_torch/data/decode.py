"""Image decode for the input pipeline, evaluation, the realtime evaluator
and `infer`: one entry, `decode_image`, for JPEG and PNG.

Port of `decode_jpeg_raw`, `decode_jpeg` and `decode_jpeg_eval` from
`ron_tensorflow_tpu/data/pipeline.py:73-111` and of the CLI's
`Image.open(path).convert("RGB")` (`ron_tensorflow_tpu/cli.py:271`). The
JAX package decodes through OpenCV (cv2), else Pillow (PIL), which take
whatever format they know; the port decodes with its own decoders and
dispatches on the file's signature: `\\xff\\xd8` to the JPEG decoder
(`data/jpeg.py`: baseline and progressive Huffman frames, libjpeg-turbo's
bits), `\\x89PNG\\r\\n\\x1a\\n` to the PNG decoder (`data/png.py`). Anything
else raises ValueError naming the format; so do the JPEG frames the decoder
refuses (arithmetic-coded, lossless, hierarchical, 12-bit, CMYK, 4:1:1).

`route` names the JAX decoder a caller follows where the two give
different bits, which happens on one kind of file, 16-bit grayscale PNG:
"cv2" (each sample's high byte) for the pipeline and the realtime
evaluator, whose JAX code tries cv2 first, and "pil" (each sample clipped
to 255) for `infer`, whose JAX code opens the file with PIL. The resize is
cv2.resize(INTER_LINEAR), bit for bit.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from . import jpeg, png
from .preprocess import VGG_MEANS
from .resize import preprocess_for_eval

_SIGNATURES = {b"GIF8": "GIF", b"BM": "BMP", b"II*\x00": "TIFF", b"MM\x00*": "TIFF", b"RIFF": "WebP (RIFF)"}


def _format(data: bytes) -> str:
    if data[:2] == b"\xff\xd8":
        return "jpeg"
    if data[:8] == png.PNG_SIGNATURE:
        return "png"
    known = next((name for sig, name in _SIGNATURES.items() if data[:len(sig)] == sig), None)
    raise ValueError(f"not a JPEG or PNG: {known or 'unknown'} image data (starts {bytes(data[:8])!r})")


def decode_image(data: bytes, route: str = "cv2") -> np.ndarray:
    """JPEG or PNG bytes -> uint8 [H, W, 3] RGB at the original resolution,
    the bits of JAX's `route` decoder ("cv2" or "pil")."""
    if _format(data) == "png":
        return png.decode_png(data, route)
    if route not in png.ROUTES:
        raise ValueError(f"route must be one of {png.ROUTES}, got {route!r}")
    return jpeg.decode_rgb(data)


def image_size(data: bytes) -> Tuple[int, int]:
    """(height, width) of a JPEG or PNG, from its header."""
    return png.png_size(data) if _format(data) == "png" else jpeg.jpeg_size(data)


def decode_jpeg_raw(data: bytes) -> np.ndarray:
    """JPEG or PNG -> uint8 [H, W, 3] RGB at its original resolution (cv2's bits)."""
    return decode_image(data)


def decode_jpeg(data: bytes, out_hw) -> np.ndarray:
    """JPEG or PNG -> float32 [H, W, 3] in [0, 1], resized to out_hw by
    cv2's bilinear warp (the train path's; eval uses the TF1 resize)."""
    return jpeg.resize_bilinear(decode_image(data), out_hw).astype(np.float32) / 255.0


def decode_jpeg_eval(data: bytes, out_hw, strategy: str) -> np.ndarray:
    """JPEG or PNG -> uint8 [out_h, out_w, 3] canvas by an eval resize
    strategy with TF1 legacy bilinear numerics (pad fill = VGG mean =
    whitened 0)."""
    raw = decode_jpeg_raw(data)
    whitened, _, _ = preprocess_for_eval(raw, np.zeros((0, 4), np.float32), strategy, out_hw)
    pixels = whitened + np.asarray(VGG_MEANS, np.float32)
    return np.clip(pixels + 0.5, 0.0, 255.0).astype(np.uint8)
