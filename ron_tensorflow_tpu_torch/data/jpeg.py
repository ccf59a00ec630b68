"""The port's JPEG decoder, its encoder and a uint8 bilinear resize: the
input pipeline, the CLI and the realtime evaluator decode with it, the
synthetic dataset (`tools/synthetic_data.py`) encodes with it, and none of
them needs OpenCV or Pillow.

`_native/jpeg_decode.c` is built with the host C compiler at first use into
the package's `_build/` (as `data/native.py` builds crc32c.c) and bound with
ctypes, which releases the GIL during each call: the pipeline's decode
thread pool runs decodes in parallel. The C code keeps no global state.

- `decode_rgb`: a baseline sequential or progressive JPEG -> uint8
  [H, W, 3] RGB, bit for bit what libjpeg-turbo gives
  `cv2.imdecode(IMREAD_COLOR)` and `PIL.Image.open(...).convert("RGB")`
  (ISLOW IDCT, fancy upsampling, jdcolor.c's fixed-point YCbCr; a
  progressive frame's coefficients buffered over all its scans, as
  jdcoefct.c does). A progressive frame whose scans leave some coefficient
  bits unknown (where libjpeg-turbo would smooth the blocks) raises naming
  the coefficient; lossless, hierarchical and arithmetic-coded frames,
  12-bit samples, 4:1:1 sampling and CMYK raise ValueError naming them.
  `data/decode.py` dispatches JPEG and PNG (`data/png.py`) to their
  decoders.
- `jpeg_size`: (height, width) from the frame header, for any frame type.
- `resize_bilinear`: `cv2.resize(image, (w, h), interpolation=INTER_LINEAR)`
  on uint8 images, bit for bit.
- `encode_jpeg`: uint8 RGB [H, W, 3] or gray [H, W] -> a baseline JFIF, as
  `PIL.Image.save(format="JPEG", quality=q)` writes it with Pillow's
  defaults (libjpeg-turbo's path: 4:2:0, ISLOW DCT, Annex K tables scaled
  to q, no optimized Huffman codes). `_native/jpeg_encode.c`, built as the
  decoder is.

Unlike `native.crc32c`, nothing here falls back: a failed build raises.
"""

from __future__ import annotations

import ctypes
import os
import threading
from typing import Optional, Tuple

import numpy as np

from .native import build_shared

_NATIVE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_native")
_SRC = os.path.join(_NATIVE, "jpeg_decode.c")
_ENC_SRC = os.path.join(_NATIVE, "jpeg_encode.c")
# the resize computes its coefficients in float, rounded as OpenCV's are: no FMA contraction
_FLAGS = ("-ffp-contract=off",)
_ERR_LEN = 256
_lib: Optional[ctypes.CDLL] = None
_enc_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()


def library() -> ctypes.CDLL:
    """The built decoder library (built and loaded at the first call)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build_shared(_SRC, "jpeg_decode", _FLAGS))
            lib.jpeg_decode_rgb.restype = ctypes.c_int
            lib.jpeg_decode_rgb.argtypes = [ctypes.c_char_p, ctypes.c_size_t, ctypes.c_void_p, ctypes.c_int,
                                            ctypes.c_int, ctypes.c_char_p, ctypes.c_size_t]
            lib.resize_bilinear_u8.restype = ctypes.c_int
            lib.resize_bilinear_u8.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                                               ctypes.c_int, ctypes.c_int, ctypes.c_int]
            _lib = lib
        return _lib


_NO_SEGMENT = {0x01, *range(0xD0, 0xD9)}  # TEM, RSTn, SOI


def jpeg_size(data: bytes) -> Tuple[int, int]:
    """(height, width) of a JPEG, from its first frame header (SOFn)."""
    if data[:2] != b"\xff\xd8":
        raise ValueError("not a JPEG (no SOI marker)")
    pos, n = 2, len(data)
    while pos < n:
        if data[pos] != 0xFF:
            pos += 1
            continue
        while pos < n and data[pos] == 0xFF:
            pos += 1
        if pos >= n:
            break
        marker = data[pos]
        pos += 1
        if marker == 0 or marker in _NO_SEGMENT:
            continue
        if pos + 2 > n:
            break
        length = (data[pos] << 8) | data[pos + 1]
        if 0xC0 <= marker <= 0xCF and marker not in (0xC4, 0xC8, 0xCC):
            if pos + 7 > n:
                break
            return (data[pos + 3] << 8) | data[pos + 4], (data[pos + 5] << 8) | data[pos + 6]
        if marker in (0xD9, 0xDA):  # EOI or a scan before any frame header
            break
        pos += length
    raise ValueError("no frame header (SOF) in the JPEG")


def decode_rgb(data: bytes) -> np.ndarray:
    """JPEG bytes -> uint8 [H, W, 3] RGB at the original resolution."""
    data = bytes(data)
    h, w = jpeg_size(data)
    out = np.empty((h, w, 3), np.uint8)
    err = ctypes.create_string_buffer(_ERR_LEN)
    if library().jpeg_decode_rgb(data, len(data), out.ctypes.data, h, w, err, _ERR_LEN):
        raise ValueError(err.value.decode(errors="replace"))
    return out


def resize_bilinear(image: np.ndarray, out_hw) -> np.ndarray:
    """uint8 [H, W, C] -> uint8 [out_h, out_w, C], as cv2.resize(INTER_LINEAR)."""
    if image.dtype != np.uint8 or image.ndim != 3:
        raise ValueError(f"resize_bilinear takes a uint8 [H, W, C] image, got {image.dtype} {image.shape}")
    src = np.ascontiguousarray(image)
    oh, ow = int(out_hw[0]), int(out_hw[1])
    out = np.empty((oh, ow, src.shape[2]), np.uint8)
    if library().resize_bilinear_u8(src.ctypes.data, src.shape[0], src.shape[1], out.ctypes.data, oh, ow,
                                    src.shape[2]):
        raise ValueError(f"cannot resize {src.shape} to {(oh, ow)}")
    return out


def encoder_library() -> ctypes.CDLL:
    """The built encoder library (built and loaded at the first call)."""
    global _enc_lib
    with _lock:
        if _enc_lib is None:
            lib = ctypes.CDLL(build_shared(_ENC_SRC, "jpeg_encode"))
            lib.jpeg_encode.restype = ctypes.c_int
            lib.jpeg_encode.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                        ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_size_t),
                                        ctypes.c_char_p, ctypes.c_size_t]
            lib.jpeg_free.restype = None
            lib.jpeg_free.argtypes = [ctypes.c_void_p]
            _enc_lib = lib
        return _enc_lib


def encode_jpeg(image: np.ndarray, quality: int = 90) -> bytes:
    """uint8 [H, W, 3] RGB, or [H, W] / [H, W, 1] gray -> baseline JPEG bytes."""
    image = np.asarray(image)
    if image.ndim == 3 and image.shape[2] == 1:
        image = image[..., 0]
    if image.dtype != np.uint8 or not (image.ndim == 2 or (image.ndim == 3 and image.shape[2] == 3)):
        raise ValueError(f"encode_jpeg takes uint8 [H, W, 3] or [H, W], got {image.dtype} {image.shape}")
    src = np.ascontiguousarray(image)
    channels = 1 if src.ndim == 2 else 3
    out, n = ctypes.c_void_p(), ctypes.c_size_t()
    err = ctypes.create_string_buffer(_ERR_LEN)
    lib = encoder_library()
    if lib.jpeg_encode(src.ctypes.data, src.shape[0], src.shape[1], channels, int(quality), ctypes.byref(out),
                       ctypes.byref(n), err, _ERR_LEN):
        raise ValueError(err.value.decode(errors="replace"))
    try:
        return ctypes.string_at(out, n.value)
    finally:
        lib.jpeg_free(out)
