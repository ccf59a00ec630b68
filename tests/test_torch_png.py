"""The port's PNG decoder and encoder (`data/png.py`) and the one decode
entry (`data/decode.py`) against Pillow and OpenCV, route by route.

- The fixtures of tests/fixtures/image_formats (every colour type at every
  bit depth, Adam7, palette with tRNS, two Pillow-written pictures) decode
  to the digests of PIL's and cv2's decodes stored beside them
  (make_image_formats.py).
- Seeded PNGs written here by that script's encoder, interlaced and not, at
  every colour type and depth, and PNGs that Pillow and cv2 write
  themselves: the "cv2" route equals cv2.imdecode(IMREAD_COLOR) and JAX's
  pipeline decode (which runs cv2 here), the "pil" route equals
  `Image.open(...).convert("RGB")`, bit for bit. On 16-bit grayscale the
  two JAX routes part (cv2 takes the high byte, PIL clips to 255) and each
  port route follows its own.
- `encode_png` reads back equal through the port's decoder and PIL.
- Corrupt data raises naming what is wrong; `decode_image` names a format
  it does not take.
"""

import hashlib
import io
import struct
import sys
import zlib
from pathlib import Path

import cv2
import numpy as np
import pytest
from PIL import Image

from ron_tensorflow_tpu.data import pipeline as jax_pipeline

from ron_tensorflow_tpu_torch.data import decode, png

FIXTURES = Path(__file__).resolve().parent / "fixtures" / "image_formats"
sys.path.insert(0, str(FIXTURES))
import make_image_formats as maker  # noqa: E402

DIGESTS = np.load(FIXTURES / "digests.npz")
COLOR_DEPTHS = [(0, 1), (0, 2), (0, 4), (0, 8), (0, 16), (2, 8), (2, 16), (3, 1), (3, 2), (3, 4), (3, 8), (4, 8),
                (4, 16), (6, 8), (6, 16)]


def pil_rgb(data):
    return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))


def cv2_rgb(data):
    return cv2.cvtColor(cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR), cv2.COLOR_BGR2RGB)


def digest(a):
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def assert_routes(data):
    """Each port route against its JAX decoder; returns (cv2's, PIL's)."""
    want_cv2, want_pil = cv2_rgb(data), pil_rgb(data)
    np.testing.assert_array_equal(decode.decode_image(data, "cv2"), want_cv2)
    np.testing.assert_array_equal(decode.decode_image(data, "pil"), want_pil)
    np.testing.assert_array_equal(decode.decode_jpeg_raw(data), jax_pipeline.decode_jpeg_raw(data))
    assert decode.image_size(data) == want_pil.shape[:2]
    return want_cv2, want_pil


@pytest.mark.parametrize("name", [n for n in DIGESTS["names"] if n.endswith(".png")])
def test_fixture_pngs_decode_to_the_stored_digests(name):
    i = list(DIGESTS["names"]).index(name)
    data = (FIXTURES / name).read_bytes()
    cv2_route, pil_route = decode.decode_image(data, "cv2"), decode.decode_image(data, "pil")
    assert cv2_route.shape == tuple(DIGESTS["shapes"][i]) and cv2_route.dtype == np.uint8
    assert digest(cv2_route) == DIGESTS["cv2"][i]
    assert digest(pil_route) == DIGESTS["pil"][i]


def test_the_fixture_digests_are_the_libraries_decodes():
    for name, want_pil, want_cv2 in zip(DIGESTS["names"], DIGESTS["pil"], DIGESTS["cv2"]):
        data = (FIXTURES / name).read_bytes()
        assert (digest(pil_rgb(data)), digest(cv2_rgb(data))) == (want_pil, want_cv2), name
    assert sum((FIXTURES / n).stat().st_size for n in DIGESTS["names"]) < 300_000


@pytest.mark.parametrize("interlace", [False, True], ids=["sequential", "adam7"])
@pytest.mark.parametrize("ctype,depth", COLOR_DEPTHS)
def test_seeded_pngs_equal_both_routes(ctype, depth, interlace):
    rng = np.random.default_rng(100 * ctype + depth + 7 * interlace)
    h, w = rng.integers(1, 40, 2)
    channels = maker.CHANNELS[ctype]
    samples = maker.seeded_samples(rng, h, w, channels, depth)
    palette = rng.integers(0, 256, (1 << depth, 3)) if ctype == 3 else None
    data = maker.write_png(samples, depth, ctype, rng, palette, interlace=interlace)
    want_cv2, want_pil = assert_routes(data)
    if ctype == 0 and depth == 16 and samples.max() > 255:
        assert not np.array_equal(want_cv2, want_pil)  # the routes part here only
        np.testing.assert_array_equal(want_cv2, np.repeat(samples >> 8, 3, -1))
        np.testing.assert_array_equal(want_pil, np.repeat(np.minimum(samples, 255), 3, -1))
    else:
        np.testing.assert_array_equal(want_cv2, want_pil)


def test_sixteen_bit_gray_follows_each_jax_route():
    """JAX's record pipeline (cv2) and its `infer` (PIL) on one 16-bit gray
    PNG: the port's "cv2" and "pil" routes give each one's bits."""
    samples = np.array([[0, 1, 255, 256], [4095, 32768, 65535, 300], [128, 255, 65280, 7]], np.uint16)[..., None]
    data = maker.write_png(samples, 16, 0, np.random.default_rng(0))
    assert (decode.decode_image(data, "cv2")[..., 0] == samples[..., 0] >> 8).all()
    assert (decode.decode_image(data, "pil")[..., 0] == np.minimum(samples[..., 0], 255)).all()
    np.testing.assert_array_equal(decode.decode_jpeg_raw(data), jax_pipeline.decode_jpeg_raw(data))
    np.testing.assert_array_equal(decode.decode_image(data, "pil"), pil_rgb(data))


@pytest.mark.parametrize("mode", ["1", "L", "P", "LA", "RGB", "RGBA", "I;16"])
def test_pngs_pillow_writes_equal_both_routes(mode):
    rng = np.random.default_rng(len(mode))
    rgb = maker.seeded_samples(rng, 33, 45, 3, 8).astype(np.uint8)
    if mode == "I;16":
        img = Image.fromarray(maker.seeded_samples(rng, 33, 45, 1, 16)[..., 0])
    elif mode == "P":
        img = Image.fromarray(rgb).quantize(57)
    elif mode in ("LA", "RGBA"):
        img = Image.fromarray(rgb).convert(mode)
        img.putalpha(Image.fromarray(rng.integers(0, 256, (33, 45), np.uint8)))
    else:
        img = Image.fromarray(rgb).convert(mode)
    buf = io.BytesIO()
    img.save(buf, format="PNG", optimize=True)
    assert_routes(buf.getvalue())


@pytest.mark.parametrize("dtype,channels", [(np.uint8, 1), (np.uint8, 3), (np.uint8, 4), (np.uint16, 3),
                                            (np.uint16, 4)])
def test_pngs_opencv_writes_equal_both_routes(dtype, channels):
    rng = np.random.default_rng(channels)
    depth = 8 * np.dtype(dtype).itemsize
    img = maker.seeded_samples(rng, 21, 34, channels, depth).astype(dtype)
    ok, enc = cv2.imencode(".png", img if channels == 1 else img[..., [2, 1, 0, 3][:channels]])
    assert ok
    assert_routes(enc.tobytes())


@pytest.mark.parametrize("image", [np.zeros((1, 1), np.uint8), np.arange(35, dtype=np.uint8).reshape(5, 7)],
                         ids=["1x1", "gray"])
def test_encode_png_gray_reads_back(image):
    data = png.encode_png(image)
    np.testing.assert_array_equal(png.decode_png(data), np.repeat(image[..., None], 3, -1))
    np.testing.assert_array_equal(np.asarray(Image.open(io.BytesIO(data))), image)


@pytest.mark.parametrize("channels", [3, 4])
def test_encode_png_reads_back_through_both_decoders(channels):
    image = np.random.default_rng(channels).integers(0, 256, (17, 29, channels), np.uint8)
    data = png.encode_png(image)
    assert data[:8] == png.PNG_SIGNATURE and png.png_size(data) == (17, 29)
    np.testing.assert_array_equal(png.decode_png(data), image[..., :3])
    np.testing.assert_array_equal(np.asarray(Image.open(io.BytesIO(data))), image)
    with pytest.raises(ValueError):
        png.encode_png(image.astype(np.float32))


def test_corrupt_pngs_raise():
    rng = np.random.default_rng(5)
    data = maker.write_png(maker.seeded_samples(rng, 9, 11, 3, 8), 8, 2, rng)
    with pytest.raises(ValueError, match="CRC mismatch"):
        png.decode_png(data[:40] + bytes([data[40] ^ 1]) + data[41:])
    with pytest.raises(ValueError, match="truncated"):
        png.decode_png(data[:-20])
    with pytest.raises(ValueError, match="not a PNG"):
        png.decode_png(b"\x89PNX" + data[4:])
    raw = bytes([5]) + bytes(33)  # filter type 5 on the first scanline
    body = zlib.compress(raw)
    bad = (png.PNG_SIGNATURE + maker.chunk(b"IHDR", struct.pack(">IIBBBBB", 11, 1, 8, 2, 0, 0, 0))
           + maker.chunk(b"IDAT", body) + maker.chunk(b"IEND", b""))
    with pytest.raises(ValueError, match="filter type 5"):
        png.decode_png(bad)
    with pytest.raises(ValueError, match="bit depth 16 with colour type 3"):
        png.decode_png(png.PNG_SIGNATURE + maker.chunk(b"IHDR", bytes.fromhex("00000001000000011003000000")))
    with pytest.raises(ValueError, match="critical"):
        png.decode_png(data[:33] + maker.chunk(b"ABCD", b"") + data[33:])


def test_decode_image_names_what_it_does_not_take():
    buf = io.BytesIO()
    Image.fromarray(np.zeros((4, 4, 3), np.uint8)).save(buf, format="GIF")
    with pytest.raises(ValueError, match="not a JPEG or PNG: GIF"):
        decode.decode_image(buf.getvalue())
    with pytest.raises(ValueError, match="route"):
        decode.decode_image(png.encode_png(np.zeros((2, 2, 3), np.uint8)), "tf")
