"""The port's native JPEG decoder and uint8 bilinear resize (`data/jpeg.py`,
`data/_native/jpeg_decode.c`) against Pillow and OpenCV, which both decode
through libjpeg-turbo: the decoder bit for bit on JPEGs that Pillow and
OpenCV write here (qualities, chroma subsamplings, grayscale, odd sizes,
restart markers, optimized Huffman tables), the header's size, the frames
it refuses; the resize against cv2.resize(INTER_LINEAR)."""

import io
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import cv2
import numpy as np
import pytest
from PIL import Image

from ron_tensorflow_tpu_torch.data import jpeg

FIXTURES = Path(__file__).resolve().parent / "fixtures"


def picture(h, w, seed=0):
    """Smooth colour gradients with noise: every DCT band carries energy."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    base = np.stack([128 + 100 * np.sin(x / 17.0 + c) * np.cos(y / 23.0 - c) for c in range(3)], -1)
    return np.clip(base + rng.normal(0, 20, base.shape), 0, 255).astype(np.uint8)


def encode(pixels, gray=False, **options):
    img = Image.fromarray(pixels)
    if gray:
        img = img.convert("L")
    buf = io.BytesIO()
    img.save(buf, format="JPEG", **options)
    return buf.getvalue()


def pil_rgb(data):
    return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))


def cv2_rgb(data):
    return cv2.cvtColor(cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR), cv2.COLOR_BGR2RGB)


def assert_decodes_as_libjpeg(data):
    ref = pil_rgb(data)
    np.testing.assert_array_equal(cv2_rgb(data), ref)  # the two references agree
    got = jpeg.decode_rgb(data)
    assert got.dtype == np.uint8 and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)
    assert jpeg.jpeg_size(data) == ref.shape[:2]


SIZES = [(1, 1), (8, 8), (3, 5), (17, 33), (64, 3), (2, 50), (333, 497)]


@pytest.mark.parametrize("quality", [50, 75, 95])
@pytest.mark.parametrize("subsampling", [0, 1, 2], ids=["444", "422", "420"])
@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_decoder_bit_equal_to_libjpeg(quality, subsampling, size):
    data = encode(picture(*size, seed=quality), quality=quality, subsampling=subsampling)
    assert_decodes_as_libjpeg(data)


@pytest.mark.parametrize("size", [(1, 1), (17, 33), (333, 497), (375, 500)], ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("options", [{"quality": 75}, {"quality": 95, "optimize": True}], ids=["q75", "optimized"])
def test_grayscale_expands_to_three_equal_channels(size, options):
    data = encode(picture(*size), gray=True, **options)
    assert_decodes_as_libjpeg(data)
    got = jpeg.decode_rgb(data)
    assert np.array_equal(got[..., 0], got[..., 1]) and np.array_equal(got[..., 0], got[..., 2])


@pytest.mark.parametrize("restart", [{"restart_marker_blocks": 1}, {"restart_marker_blocks": 7},
                                     {"restart_marker_rows": 1}, {"restart_marker_rows": 3}],
                         ids=lambda r: "-".join(f"{k}{v}" for k, v in r.items()))
@pytest.mark.parametrize("subsampling", [0, 1, 2], ids=["444", "422", "420"])
def test_restart_markers(restart, subsampling):
    data = encode(picture(333, 497, seed=3), quality=80, subsampling=subsampling, **restart)
    assert b"\xff\xdd" in data  # a DRI segment
    assert_decodes_as_libjpeg(data)


@pytest.mark.parametrize("subsampling", [0, 1, 2], ids=["444", "422", "420"])
def test_optimized_huffman_tables(subsampling, monkeypatch):
    from PIL import ImageFile

    monkeypatch.setattr(ImageFile, "MAXBLOCK", 1 << 22)  # room for a one-pass optimized encode of noise
    assert_decodes_as_libjpeg(encode(picture(333, 497, seed=4), quality=90, subsampling=subsampling,
                                     optimize=True))


def test_h1v2_chroma_written_by_opencv():
    """4:4:0 (chroma halved vertically only), which Pillow cannot write."""
    bgr = picture(375, 500, seed=5)
    ok, enc = cv2.imencode(".jpg", bgr, [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440,
                                         cv2.IMWRITE_JPEG_QUALITY, 85])
    assert ok
    assert_decodes_as_libjpeg(enc.tobytes())


def test_the_fixture_images():
    for path in sorted((FIXTURES / "voc_mini" / "VOC2007" / "JPEGImages").glob("*.jpg")):
        assert_decodes_as_libjpeg(path.read_bytes())


def test_progressive_and_other_frames_raise_naming_the_frame():
    pixels = picture(40, 56)
    # a progressive frame decodes (tests/test_torch_jpeg_progressive.py); the others raise
    assert_decodes_as_libjpeg(encode(pixels, progressive=True))
    assert jpeg.jpeg_size(encode(pixels, progressive=True)) == (40, 56)
    cmyk = io.BytesIO()
    Image.fromarray(pixels).convert("CMYK").save(cmyk, format="JPEG")
    with pytest.raises(ValueError, match="4-component JPEG is not supported.*CMYK"):
        jpeg.decode_rgb(cmyk.getvalue())
    baseline = encode(pixels)
    sof = baseline.index(b"\xff\xc0")
    for marker, name in ((b"\xff\xc9", "arithmetic-coded sequential"), (b"\xff\xc3", "lossless")):
        with pytest.raises(ValueError, match=name):
            jpeg.decode_rgb(baseline[:sof] + marker + baseline[sof + 2:])
    twelve_bit = bytearray(baseline)
    twelve_bit[sof + 4] = 12  # the frame's sample precision
    with pytest.raises(ValueError, match="12-bit sample precision"):
        jpeg.decode_rgb(bytes(twelve_bit))


def test_corrupt_data_raises():
    data = encode(picture(64, 64), quality=90)
    with pytest.raises(ValueError, match="truncated"):
        jpeg.decode_rgb(data[: len(data) // 2])
    with pytest.raises(ValueError, match="not a JPEG"):
        jpeg.decode_rgb(b"GIF89a" + data)
    with pytest.raises(ValueError, match="no frame header"):
        jpeg.jpeg_size(data[:2] + b"\xff\xd9")


def test_decoder_keeps_no_state_between_threads():
    """Many threads decode different images at once: each result is still
    libjpeg's (the C code keeps no global state; ctypes drops the GIL)."""
    cases = [encode(picture(97 + 13 * i, 131 - 7 * i, seed=i), quality=60 + 5 * i, subsampling=i % 3,
                    **({"restart_marker_rows": 1} if i % 2 else {})) for i in range(8)]
    refs = [pil_rgb(c) for c in cases]
    barrier = threading.Barrier(8)

    def work(i):
        barrier.wait(timeout=30)
        return all(np.array_equal(jpeg.decode_rgb(cases[(i + k) % 8]), refs[(i + k) % 8]) for k in range(16))

    with ThreadPoolExecutor(max_workers=8) as pool:
        assert all(pool.map(work, range(8)))


RESIZES = [((320, 320), (512, 512)), ((375, 500), (512, 512)), ((500, 375), (512, 512)),
           ((333, 497), (512, 512)), ((512, 512), (320, 320)), ((1024, 1024), (512, 512)),
           ((100, 37), (64, 64)), ((7, 9), (512, 300)), ((1, 1), (5, 5)), ((300, 300), (301, 299)),
           ((64, 64), (64, 64))]


@pytest.mark.parametrize("src_hw,out_hw", RESIZES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_resize_matches_cv2(src_hw, out_hw):
    """Aims for cv2's bits; the gate is 1 level, and the share of unequal
    pixels is printed (0 where the fixed-point arithmetic is matched)."""
    rng = np.random.default_rng(src_hw[0] * 7 + out_hw[1])
    for image in (rng.integers(0, 256, (*src_hw, 3), dtype=np.uint8), picture(*src_hw)):
        ref = cv2.resize(image, (out_hw[1], out_hw[0]), interpolation=cv2.INTER_LINEAR)
        got = jpeg.resize_bilinear(image, out_hw)
        diff = np.abs(got.astype(np.int16) - ref)
        print(f"resize {src_hw} -> {out_hw}: max |native - cv2| {diff.max()}, unequal share {(diff > 0).mean():.6f}")
        assert got.shape == ref.shape and diff.max() <= 1


def test_resize_of_one_channel_and_bad_input():
    image = picture(45, 70)[..., :1].copy()
    ref = cv2.resize(image[..., 0], (64, 32), interpolation=cv2.INTER_LINEAR)
    np.testing.assert_array_equal(jpeg.resize_bilinear(image, (32, 64))[..., 0], ref)
    with pytest.raises(ValueError, match="uint8"):
        jpeg.resize_bilinear(image.astype(np.float32), (32, 64))
