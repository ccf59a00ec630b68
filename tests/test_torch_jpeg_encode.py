"""The port's JPEG encoder (`data/jpeg.py::encode_jpeg` over
`data/_native/jpeg_encode.c`) against Pillow's, which JAX's synthetic tool
writes its records with.

- Byte for byte: at quality 90 (the synthetic tool's) and at other
  qualities, RGB and gray, at sizes that are not multiples of 8 or 16
  (partial MCUs, dummy blocks), the port's bytes equal
  `PIL.Image.save(format="JPEG", quality=q)`'s.
- Decode: the port's decoder gives, from the port's bytes, exactly what
  Pillow decodes from them.
- Fidelity: at quality 90, smooth images (sinusoids plus noise of std 4)
  come back within PSNR >= 34 dB in RGB (4:2:0 chroma) and >= 38 dB in gray
  (measured: 35.4-35.6 and 39.2).
"""

import io
import subprocess

import numpy as np
import pytest
from PIL import Image

from ron_tensorflow_tpu_torch.data import jpeg, native
from ron_tensorflow_tpu_torch.data.jpeg import decode_rgb, encode_jpeg

SIZES = [(1, 1), (8, 8), (9, 17), (17, 9), (23, 31), (37, 53), (64, 64), (100, 23)]
PSNR_RGB = 34.0
PSNR_GRAY = 38.0


def noisy(h, w, c, seed):
    """Noise with a flat block: runs of zeros and large coefficients alike."""
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, (h, w, c), np.uint8)
    img[h // 3:, : (w + 1) // 2] = rng.integers(0, 256, c)
    return img if c == 3 else img[..., 0]


def smooth(h, w, c, seed=0):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.stack([128 + 100 * np.sin(xx / 7 + k) * np.cos(yy / 11 - k) for k in range(c)], -1)
    img = np.clip(base + rng.normal(0, 4, base.shape), 0, 255).astype(np.uint8)
    return img if c == 3 else img[..., 0]


def pil_jpeg(img, quality):
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="JPEG", quality=quality)
    return buf.getvalue()


def pil_decode(data):
    return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))


@pytest.mark.parametrize("channels", [3, 1], ids=["rgb", "gray"])
@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_encode_equals_pillow_and_decodes_as_pillow_does(size, channels):
    img = noisy(*size, channels, seed=size[0] * 100 + size[1])
    data = encode_jpeg(img, quality=90)
    assert data == pil_jpeg(img, 90)
    assert data[:2] == b"\xff\xd8" and data[-2:] == b"\xff\xd9"
    got = decode_rgb(data)
    assert got.shape == (*size, 3)
    np.testing.assert_array_equal(got, pil_decode(data))


@pytest.mark.parametrize("quality", [1, 10, 50, 75, 95, 100])
def test_quality_scaling_equals_pillow(quality):
    img = noisy(29, 41, 3, seed=quality)
    assert encode_jpeg(img, quality) == pil_jpeg(img, quality)


@pytest.mark.parametrize("shape", [(37, 53, 3), (200, 150, 3), (23, 31, 1)], ids=str)
def test_quality_90_psnr(shape):
    img = smooth(*shape)
    got = decode_rgb(encode_jpeg(img, 90)).astype(np.float64)
    ref = img.astype(np.float64) if img.ndim == 3 else np.repeat(img[..., None].astype(np.float64), 3, -1)
    psnr = 10 * np.log10(255.0 ** 2 / ((got - ref) ** 2).mean())
    assert psnr >= (PSNR_RGB if img.ndim == 3 else PSNR_GRAY), psnr


def test_gray_with_a_channel_axis_is_gray():
    img = noisy(19, 21, 1, seed=3)
    assert encode_jpeg(img[..., None]) == encode_jpeg(img)


@pytest.mark.parametrize("bad, quality", [
    (np.zeros((8, 8, 3), np.float32), 90),
    (np.zeros((8, 8, 4), np.uint8), 90),
    (np.zeros((8,), np.uint8), 90),
    (np.zeros((8, 8, 3), np.uint8), 0),
    (np.zeros((8, 8, 3), np.uint8), 101),
    (np.zeros((0, 8, 3), np.uint8), 90),
])
def test_rejects_what_it_cannot_encode(bad, quality):
    with pytest.raises(ValueError):
        encode_jpeg(bad, quality)


def test_a_failed_build_raises(tmp_path, monkeypatch):
    """No fallback: without a working C compiler the encoder raises."""
    monkeypatch.setattr(native, "_BUILD_DIR", str(tmp_path))  # nothing built there yet
    monkeypatch.setattr(jpeg, "_enc_lib", None)
    monkeypatch.setenv("CC", "false")
    with pytest.raises(subprocess.SubprocessError):
        encode_jpeg(np.zeros((8, 8, 3), np.uint8))
