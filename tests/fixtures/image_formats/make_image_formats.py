"""Write the image-format fixtures of tests/fixtures/image_formats.

    python tests/fixtures/image_formats/make_image_formats.py

Needs numpy, Pillow and OpenCV (cv2), which hold the references. Writes,
beside this script:

- PNGs of every colour type at every bit depth it allows (gray 1, 2, 4, 8,
  16; RGB 8, 16; palette 1, 2, 4, 8; gray+alpha 8, 16; RGBA 8, 16), drawn
  from a numpy seed and written by the small encoder below, each scanline
  with a filter type drawn from the seed (all five occur); one Adam7 image,
  one palette image with tRNS, and two PNGs of tests/fixtures/voc_mini
  images (downscaled, written by Pillow with optimize=True) for `infer`;
- progressive JPEGs re-encoded from two voc_mini images: 4:2:0 and 4:4:4
  (Pillow), gray (Pillow), one with restart markers (cv2) and one cropped to
  odd dimensions (Pillow, optimized Huffman tables);
- digests.npz: for each file, the sha256 of the uint8 RGB array that
  `PIL.Image.open(...).convert("RGB")` gives and of the one that
  `cv2.imdecode(..., IMREAD_COLOR)` gives (converted to RGB), and its shape.
  The two differ on the 16-bit grayscale PNG only.
"""

from __future__ import annotations

import hashlib
import io
import struct
import zlib
from pathlib import Path

import cv2
import numpy as np
from PIL import Image

HERE = Path(__file__).resolve().parent
VOC = HERE.parent / "voc_mini" / "VOC2007" / "JPEGImages"
ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))
CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
INFER_PNGS = ("voc_000001.png", "voc_000005.png")
INFER_JPEGS = ("prog_420.jpg", "prog_odd.jpg")


def paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def filter_rows(raw, bpp, rng):
    """Filter each scanline of raw [h, stride] uint8 with a type drawn from rng."""
    out, prev = [], np.zeros(raw.shape[1], np.int32)
    for row in raw.astype(np.int32):
        t = int(rng.integers(0, 5))
        left = np.concatenate([np.zeros(bpp, np.int32), row[:-bpp]])
        up_left = np.concatenate([np.zeros(bpp, np.int32), prev[:-bpp]])
        pred = [0, left, prev, (left + prev) >> 1, paeth(left, prev, up_left)][t]
        out.append(bytes([t]) + ((row - pred) & 0xFF).astype(np.uint8).tobytes())
        prev = row
    return b"".join(out)


def pack(samples, depth):
    """uint16 [h, w, c] samples -> [h, stride] uint8 scanlines at depth."""
    h = samples.shape[0]
    flat = samples.reshape(h, -1)
    if depth == 16:
        return flat.astype(">u2").view(np.uint8).reshape(h, -1)
    if depth == 8:
        return flat.astype(np.uint8)
    bits = ((flat[..., None] >> np.arange(depth - 1, -1, -1)) & 1).reshape(h, -1).astype(np.uint8)
    return np.packbits(bits, axis=1)


def chunk(kind, body):
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))


def write_png(samples, depth, ctype, rng, palette=None, trns=None, interlace=False):
    h, w, c = samples.shape
    bpp = max(1, c * depth // 8)
    if interlace:
        data = b"".join(filter_rows(pack(samples[y0::dy, x0::dx], depth), bpp, rng)
                        for x0, y0, dx, dy in ADAM7 if w > x0 and h > y0)
    else:
        data = filter_rows(pack(samples, depth), bpp, rng)
    out = b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0, int(interlace)))
    out += chunk(b"tEXt", b"Comment\x00seeded fixture")  # an ancillary chunk to skip
    if palette is not None:
        out += chunk(b"PLTE", palette.astype(np.uint8).tobytes())
    if trns is not None:
        out += chunk(b"tRNS", trns)
    # the image data in two IDAT chunks
    z = zlib.compress(data, 9)
    return out + chunk(b"IDAT", z[: len(z) // 2]) + chunk(b"IDAT", z[len(z) // 2:]) + chunk(b"IEND", b"")


def seeded_samples(rng, h, w, c, depth):
    """Smooth ramps plus noise, full range of depth."""
    top = (1 << depth) - 1
    y, x = np.mgrid[0:h, 0:w]
    base = np.stack([(np.sin(x / 5.0 + k) * np.cos(y / 7.0 - k) + 1) / 2 for k in range(c)], -1)
    noisy = base * top + rng.normal(0, top * 0.08 + 0.5, (h, w, c))
    return np.clip(np.rint(noisy), 0, top).astype(np.uint16)


def pngs(rng):
    files = {}
    for ctype, depths in ((0, (1, 2, 4, 8, 16)), (2, (8, 16)), (4, (8, 16)), (6, (8, 16))):
        for depth in depths:
            name = {0: "gray", 2: "rgb", 4: "graya", 6: "rgba"}[ctype]
            files[f"{name}{depth}.png"] = write_png(seeded_samples(rng, 23, 37, CHANNELS[ctype], depth), depth,
                                                    ctype, rng)
    for depth in (1, 2, 4, 8):
        n = 1 << depth
        palette = rng.integers(0, 256, (n, 3))
        files[f"pal{depth}.png"] = write_png(seeded_samples(rng, 29, 19, 1, depth), depth, 3, rng, palette)
    palette = rng.integers(0, 256, (200, 3))
    idx = rng.integers(0, 200, (31, 27, 1)).astype(np.uint16)
    files["pal8_trns.png"] = write_png(idx, 8, 3, rng, palette, trns=bytes(rng.integers(0, 256, 120).tolist()))
    files["adam7_rgb8.png"] = write_png(seeded_samples(rng, 29, 21, 3, 8), 8, 2, rng, interlace=True)
    for name in INFER_PNGS:
        src = Image.open(VOC / name.replace("voc_", "").replace(".png", ".jpg")).convert("RGB")
        buf = io.BytesIO()
        src.resize((src.width // 3, src.height // 3), Image.BILINEAR).save(buf, format="PNG", optimize=True)
        files[name] = buf.getvalue()
    return files


def progressive_jpegs():
    a = Image.open(VOC / "000001.jpg").convert("RGB")
    b = Image.open(VOC / "000005.jpg").convert("RGB")
    files = {}
    for name, img, kw in (("prog_420.jpg", a, {"subsampling": 2}), ("prog_444.jpg", b, {"subsampling": 0}),
                          ("prog_gray.jpg", b.convert("L"), {}),
                          ("prog_odd.jpg", b.crop((7, 5, 7 + 333, 5 + 251)), {"optimize": True})):
        buf = io.BytesIO()
        img.save(buf, format="JPEG", quality=75, progressive=True, **kw)
        files[name] = buf.getvalue()
    ok, enc = cv2.imencode(".jpg", np.asarray(a)[..., ::-1], [cv2.IMWRITE_JPEG_QUALITY, 75,
                                                              cv2.IMWRITE_JPEG_PROGRESSIVE, 1,
                                                              cv2.IMWRITE_JPEG_RST_INTERVAL, 7])
    assert ok
    files["prog_rst.jpg"] = enc.tobytes()
    return files


def pil_rgb(data):
    return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))


def cv2_rgb(data):
    return cv2.cvtColor(cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR), cv2.COLOR_BGR2RGB)


def digest(a):
    return hashlib.sha256(np.ascontiguousarray(a, np.uint8).tobytes()).hexdigest()


def main():
    rng = np.random.default_rng(20261018)
    files = {**pngs(rng), **progressive_jpegs()}
    names, pil, cv, shapes = [], [], [], []
    for name, data in sorted(files.items()):
        (HERE / name).write_bytes(data)
        p, c = pil_rgb(data), cv2_rgb(data)
        names.append(name)
        pil.append(digest(p))
        cv.append(digest(c))
        shapes.append(p.shape)
        print(f"{name}: {len(data)} bytes, {p.shape}, PIL and cv2 {'agree' if np.array_equal(p, c) else 'DIFFER'}")
    np.savez(HERE / "digests.npz", names=np.array(names), pil=np.array(pil), cv2=np.array(cv),
             shapes=np.array(shapes, np.int64), infer_pngs=np.array(INFER_PNGS), infer_jpegs=np.array(INFER_JPEGS))
    print(f"{sum(len(d) for d in files.values())} bytes in {len(files)} files")


if __name__ == "__main__":
    main()
