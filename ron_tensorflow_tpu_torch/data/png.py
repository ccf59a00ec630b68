"""The port's PNG decoder and encoder, for hosts without OpenCV or Pillow.

The JAX package opens PNGs through cv2 (`cv2.imdecode(IMREAD_COLOR)`, the
record pipeline's and the realtime evaluator's first choice) or PIL
(`Image.open(...).convert("RGB")`, the CLI's `infer`). `decode_png` gives
their RGB bits: chunks read with their CRCs checked (IHDR, PLTE, IDAT,
IEND; tRNS and the other ancillary chunks skipped: alpha is dropped as both
drop it), the image data inflated with the standard `zlib`, the five
scanline filters undone in C (`_native/png_unfilter.c`, built with the host
C compiler at first use as `data/native.py` builds the other helpers, and
bound with ctypes), Adam7 passes put in place, and every colour type at
every bit depth it allows turned into RGB: grayscale below 8 bits scaled to
0-255 (x255, x85, x17), palette entries looked up, 16-bit samples cut to
their high byte.

The two JAX routes part on one kind of file: 16-bit grayscale (colour type
0). cv2 takes each sample's high byte; PIL's "I;16" image converts to RGB by
clipping each sample to 255. `route` picks the one to follow, "cv2" or
"pil". Every other PNG decodes the same on both.

`encode_png` writes uint8 gray, RGB or RGBA with filter 0 on every scanline
and the standard `zlib`, with CRCs: TensorBoard's image summaries.
"""

from __future__ import annotations

import ctypes
import os
import struct
import threading
import zlib
from typing import Optional, Tuple

import numpy as np

from .native import build_shared

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
ROUTES = ("cv2", "pil")  # the JAX decoders a caller follows
# colour type -> (samples a pixel, the bit depths it allows)
COLOR_TYPES = {0: (1, (1, 2, 4, 8, 16)), 2: (3, (8, 16)), 3: (1, (1, 2, 4, 8)), 4: (2, (8, 16)), 6: (4, (8, 16))}
# Adam7: (first column, first row, column step, row step) of each pass
ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_native", "png_unfilter.c")
_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()


def library() -> ctypes.CDLL:
    """The built unfilter library (built and loaded at the first call)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build_shared(_SRC, "png_unfilter"))
            lib.png_unfilter.restype = ctypes.c_int
            lib.png_unfilter.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_size_t, ctypes.c_int,
                                         ctypes.c_void_p]
            _lib = lib
        return _lib


def _chunks(data: bytes):
    """(type, body) of each chunk up to IEND, CRCs checked."""
    if data[:8] != PNG_SIGNATURE:
        raise ValueError("not a PNG (no PNG signature)")
    pos, n = 8, len(data)
    while True:
        if pos + 8 > n:
            raise ValueError("truncated PNG: no IEND chunk")
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        end = pos + 8 + length
        if end + 4 > n:
            raise ValueError(f"truncated PNG: chunk {kind!r} runs past the end of the data")
        body = data[pos + 8:end]
        if zlib.crc32(kind + body) != struct.unpack(">I", data[end:end + 4])[0]:
            raise ValueError(f"corrupt PNG: CRC mismatch in chunk {kind!r}")
        yield kind, body
        if kind == b"IEND":
            return
        pos = end + 4


def _header(body: bytes):
    if len(body) != 13:
        raise ValueError("bad PNG: IHDR is not 13 bytes")
    w, h, depth, ctype, compression, filtering, interlace = struct.unpack(">IIBBBBB", body)
    if w == 0 or h == 0:
        raise ValueError("bad PNG: width or height 0")
    if ctype not in COLOR_TYPES or depth not in COLOR_TYPES[ctype][1]:
        raise ValueError(f"bad PNG: bit depth {depth} with colour type {ctype}")
    if compression or filtering or interlace > 1:
        raise ValueError(f"bad PNG: compression {compression}, filter method {filtering}, interlace {interlace}")
    return h, w, depth, ctype, interlace


def png_size(data: bytes) -> Tuple[int, int]:
    """(height, width) of a PNG, from its IHDR."""
    if data[:8] != PNG_SIGNATURE:
        raise ValueError("not a PNG (no PNG signature)")
    if len(data) < 33 or data[12:16] != b"IHDR":
        raise ValueError("bad PNG: no IHDR chunk first")
    return _header(bytes(data[16:29]))[:2]


def _samples(raw: memoryview, h: int, w: int, depth: int, channels: int) -> Tuple[np.ndarray, int]:
    """Unfilter one (sub)image of h scanlines from raw -> (uint16 [h, w,
    channels] samples, the bytes it took)."""
    stride = (w * channels * depth + 7) // 8
    size = h * (stride + 1)
    if len(raw) < size:
        raise ValueError("truncated PNG: the image data ends early")
    out = np.empty((h, stride), np.uint8)
    bad = library().png_unfilter(bytes(raw[:size]), h, stride, max(1, channels * depth // 8), out.ctypes.data)
    if bad:
        raise ValueError(f"corrupt PNG: scanline {bad - 1} has filter type {raw[(bad - 1) * (stride + 1)]}")
    if depth == 16:
        return out.view(">u2").astype(np.uint16).reshape(h, w, channels), size
    if depth == 8:
        return out.reshape(h, w, channels).astype(np.uint16), size
    bits = np.unpackbits(out, axis=1)[:, : w * depth].reshape(h, w, depth).astype(np.uint16)
    weights = (1 << np.arange(depth - 1, -1, -1)).astype(np.uint16)
    return (bits * weights).sum(-1, dtype=np.uint16)[..., None], size


def decode_png(data: bytes, route: str = "cv2") -> np.ndarray:
    """PNG bytes -> uint8 [H, W, 3] RGB, the bits of JAX's `route` decoder:
    16-bit grayscale becomes 8-bit by its high byte ("cv2") or by clipping
    to 255 ("pil")."""
    if route not in ROUTES:
        raise ValueError(f"route must be one of {ROUTES}, got {route!r}")
    data = bytes(data)
    header, palette, idat = None, None, []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            header = _header(body)
        elif header is None:
            raise ValueError(f"bad PNG: chunk {kind!r} before IHDR")
        elif kind == b"PLTE":
            if len(body) % 3 or not 3 <= len(body) <= 768:
                raise ValueError(f"bad PNG: PLTE of {len(body)} bytes")
            palette = np.zeros((256, 3), np.uint8)  # an index past the entries reads black
            palette[: len(body) // 3] = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind != b"IEND" and not kind[0] & 0x20:
            raise ValueError(f"PNG chunk {kind!r} is critical and not supported")
    h, w, depth, ctype, interlace = header
    channels = COLOR_TYPES[ctype][0]
    if ctype == 3 and palette is None:
        raise ValueError("bad PNG: a palette image without PLTE")
    if not idat:
        raise ValueError("bad PNG: no IDAT chunk")
    try:
        raw = memoryview(zlib.decompress(b"".join(idat)))
    except zlib.error as e:
        raise ValueError(f"corrupt PNG: the image data does not inflate ({e})") from e
    if not interlace:
        samples, _ = _samples(raw, h, w, depth, channels)
    else:
        samples, pos = np.zeros((h, w, channels), np.uint16), 0
        for x0, y0, dx, dy in ADAM7:
            pw, ph = max(0, (w - x0 + dx - 1) // dx), max(0, (h - y0 + dy - 1) // dy)
            if pw and ph:
                sub, size = _samples(raw[pos:], ph, pw, depth, channels)
                samples[y0::dy, x0::dx] = sub
                pos += size
    if ctype == 3:
        return palette[samples[..., 0]]
    color = samples[..., :3] if ctype in (2, 6) else np.repeat(samples[..., :1], 3, axis=-1)
    if depth < 8:
        return (color * (255 // ((1 << depth) - 1))).astype(np.uint8)
    if depth == 16:
        if ctype == 0 and route == "pil":
            return np.minimum(color, 255).astype(np.uint8)
        return (color >> 8).astype(np.uint8)
    return color.astype(np.uint8)


def _chunk(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))


def encode_png(image: np.ndarray) -> bytes:
    """uint8 [H, W] or [H, W, 1] gray, [H, W, 3] RGB or [H, W, 4] RGBA ->
    PNG bytes: filter 0 on every scanline, deflated by zlib."""
    image = np.asarray(image)
    if image.ndim == 2:
        image = image[..., None]
    if image.dtype != np.uint8 or image.ndim != 3 or image.shape[2] not in (1, 3, 4) or 0 in image.shape:
        raise ValueError(f"encode_png takes uint8 [H, W(, 1|3|4)], got {image.dtype} {image.shape}")
    h, w, c = image.shape
    ctype = {1: 0, 3: 2, 4: 6}[c]
    rows = np.concatenate([np.zeros((h, 1), np.uint8), image.reshape(h, w * c)], axis=1)
    return (PNG_SIGNATURE + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0))
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)) + _chunk(b"IEND", b""))
