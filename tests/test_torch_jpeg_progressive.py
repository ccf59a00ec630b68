"""Progressive JPEG (SOF2) in the port's decoder (`data/_native/jpeg_decode.c`)
against libjpeg-turbo as Pillow and OpenCV run it, bit for bit.

- The fixtures of tests/fixtures/image_formats (4:2:0, 4:4:4, gray,
  restart markers, odd dimensions, re-encoded from two voc_mini images)
  decode to the digests of PIL's and cv2's decodes stored beside them.
- Seeded pictures encoded here with Pillow (qualities, every chroma
  subsampling, gray, optimized tables, sizes from 1x1 to ragged MCUs) and
  with OpenCV (restart intervals): each scan script is complete, so
  libjpeg-turbo does not smooth the blocks, and the port's decode equals
  both libraries'. JAX's decode functions, which run cv2 here, equal the
  port's on them.
- A progressive file cut before its last scans (an incomplete scan script,
  where libjpeg-turbo would smooth) raises naming the missing coefficient;
  a truncated scan raises; frames the decoder does not take (arithmetic-
  coded progressive, 4:1:1 sampling) raise naming them.
"""

import hashlib
import io
from pathlib import Path

import cv2
import numpy as np
import pytest
from PIL import Image

from ron_tensorflow_tpu.data import pipeline as jax_pipeline

from ron_tensorflow_tpu_torch.data import decode, jpeg

FIXTURES = Path(__file__).resolve().parent / "fixtures" / "image_formats"
DIGESTS = np.load(FIXTURES / "digests.npz")
SIZES = [(1, 1), (8, 8), (9, 17), (31, 45), (64, 3), (97, 120)]


def pil_rgb(data):
    return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))


def cv2_rgb(data):
    return cv2.cvtColor(cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR), cv2.COLOR_BGR2RGB)


def picture(h, w, seed=0):
    rng = np.random.default_rng(seed + h * 1000 + w)
    y, x = np.mgrid[0:h, 0:w]
    base = np.stack([128 + 100 * np.sin(x / 7.0 + c) * np.cos(y / 11.0 - c) for c in range(3)], -1)
    return np.clip(base + rng.normal(0, 20, (h, w, 3)), 0, 255).astype(np.uint8)


def pil_progressive(pixels, **kw):
    buf = io.BytesIO()
    Image.fromarray(pixels).save(buf, format="JPEG", progressive=True, **kw)
    return buf.getvalue()


def assert_libjpeg_bits(data):
    assert b"\xff\xc2" in data  # a progressive frame
    ref = pil_rgb(data)
    np.testing.assert_array_equal(cv2_rgb(data), ref)
    np.testing.assert_array_equal(jpeg.decode_rgb(data), ref)
    np.testing.assert_array_equal(decode.decode_image(data, "pil"), ref)


@pytest.mark.parametrize("name", [n for n in DIGESTS["names"] if n.endswith(".jpg")])
def test_fixture_progressive_jpegs_decode_to_the_stored_digests(name):
    i = list(DIGESTS["names"]).index(name)
    data = (FIXTURES / name).read_bytes()
    assert b"\xff\xc2" in data
    got = decode.decode_image(data)
    assert got.shape == tuple(DIGESTS["shapes"][i])
    digest = hashlib.sha256(got.tobytes()).hexdigest()
    assert digest == DIGESTS["cv2"][i] == DIGESTS["pil"][i]
    np.testing.assert_array_equal(decode.decode_jpeg_raw(data), jax_pipeline.decode_jpeg_raw(data))


@pytest.mark.parametrize("quality", [30, 75, 95])
@pytest.mark.parametrize("subsampling", [0, 1, 2], ids=["444", "422", "420"])
@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_pillow_progressive_equals_libjpeg(size, subsampling, quality):
    assert_libjpeg_bits(pil_progressive(picture(*size), quality=quality, subsampling=subsampling))


@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_gray_and_optimized_progressive_equal_libjpeg(size):
    pixels = picture(*size, seed=1)
    assert_libjpeg_bits(pil_progressive(pixels[..., 0], quality=80))
    assert_libjpeg_bits(pil_progressive(pixels, quality=85, optimize=True))


@pytest.mark.parametrize("rst", [1, 2, 5])
@pytest.mark.parametrize("size", [(37, 53), (64, 64), (120, 97)], ids=lambda s: f"{s[0]}x{s[1]}")
def test_opencv_progressive_with_restart_markers_equals_libjpeg(size, rst):
    ok, enc = cv2.imencode(".jpg", picture(*size, seed=2)[..., ::-1],
                           [cv2.IMWRITE_JPEG_PROGRESSIVE, 1, cv2.IMWRITE_JPEG_RST_INTERVAL, rst,
                            cv2.IMWRITE_JPEG_QUALITY, 80])
    assert ok
    data = enc.tobytes()
    assert b"\xff\xdd" in data and b"\xff\xd0" in data  # DRI and RST0
    assert_libjpeg_bits(data)


def test_jax_decode_functions_equal_on_progressive():
    data = pil_progressive(picture(45, 70), quality=75)
    np.testing.assert_array_equal(decode.decode_jpeg_raw(data), jax_pipeline.decode_jpeg_raw(data))
    np.testing.assert_array_equal(decode.decode_jpeg(data, (32, 48)), jax_pipeline.decode_jpeg(data, (32, 48)))
    np.testing.assert_array_equal(decode.decode_jpeg_eval(data, (64, 64), "WARP_RESIZE"),
                                  jax_pipeline.decode_jpeg_eval(data, (64, 64), "WARP_RESIZE"))


def test_incomplete_scan_script_raises_naming_the_coefficient():
    data = pil_progressive(picture(40, 56), quality=75)
    last_scan = data.rindex(b"\xff\xda")
    cut = data[:last_scan] + b"\xff\xd9"  # the last scan (a refinement) dropped
    with pytest.raises(ValueError, match=r"incomplete progressive JPEG: component \d+ coefficient \d+"):
        jpeg.decode_rgb(cut)
    first_ac = data.index(b"\xff\xda", data.index(b"\xff\xda") + 2)
    with pytest.raises(ValueError, match="coefficient 0 lacks its lowest 1 bits"):
        jpeg.decode_rgb(data[:first_ac] + b"\xff\xd9")  # only the first DC scan, at Al = 1
    with pytest.raises(ValueError, match="truncated"):
        jpeg.decode_rgb(data[: first_ac + 12])  # 2 bytes into the first AC scan's data
    gray = pil_progressive(picture(40, 56)[..., 0], quality=75)
    gray_ac = gray.index(b"\xff\xda", gray.index(b"\xff\xda") + 2)
    dc_refine = gray.index(b"\xff\xda\x00\x08\x01\x01\x00\x00\x00\x10", gray_ac)
    after = gray.index(b"\xff\xda", dc_refine + 2)
    with pytest.raises(ValueError, match="coefficient 1 has no scan"):
        jpeg.decode_rgb(gray[:gray_ac] + gray[dc_refine:after] + b"\xff\xd9")  # the two DC scans only


def test_other_frames_still_raise():
    data = pil_progressive(picture(40, 56), quality=75)
    sof = data.index(b"\xff\xc2")
    with pytest.raises(ValueError, match="arithmetic-coded progressive"):
        jpeg.decode_rgb(data[:sof] + b"\xff\xca" + data[sof + 2:])
    four_one_one = bytearray(data)
    four_one_one[sof + 11] = 0x41  # the first component's sampling factors: 4x1
    with pytest.raises(ValueError, match="sampling factors 4x1"):
        jpeg.decode_rgb(bytes(four_one_one))
