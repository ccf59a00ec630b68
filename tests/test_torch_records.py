"""The port's record layer against the JAX package's: the Example codec,
crc32c (native library and numpy table), TFRecord framing, shard listing."""

import os

import numpy as np
import pytest

from ron_tensorflow_tpu.data import example as jax_example
from ron_tensorflow_tpu.data import native as jax_native
from ron_tensorflow_tpu.data import tfrecord as jax_tfrecord

from ron_tensorflow_tpu_torch.data import example, native, tfrecord


def seeded_features(rng, module):
    """One Example's features from `rng`, encoded with `module`'s helpers."""
    return {
        "image/encoded": module.bytes_feature(rng.integers(0, 256, int(rng.integers(0, 4000)), np.uint8).tobytes()),
        "image/format": module.bytes_feature(b"jpeg"),
        "image/shape": module.int64_feature([int(v) for v in rng.integers(1, 1000, 3)]),
        "image/object/bbox/xmin": module.float_feature([float(v) for v in rng.uniform(0, 1, 5)]),
        "image/object/bbox/label": module.int64_feature([int(v) for v in rng.integers(-3, 2 ** 40, 5)]),
        "image/object/bbox/names": module.bytes_feature([b"dog", b"person", b""]),
        "image/id": module.int64_feature(int(rng.integers(0, 2 ** 62))),
    }


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_example_codec_is_byte_equal_to_jax(seed):
    ours = example.encode_example(seeded_features(np.random.default_rng(seed), example))
    theirs = jax_example.encode_example(seeded_features(np.random.default_rng(seed), jax_example))
    assert ours == theirs
    assert example.decode_example(ours) == jax_example.decode_example(theirs)
    assert example._varint(2 ** 63 + 5) == jax_example._varint(2 ** 63 + 5)


def payloads(seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, n, np.uint8).tobytes() for n in (0, 1, 7, 8, 9, 63, 1000, 65537)]


@pytest.mark.parametrize("with_native", [True, False], ids=["native", "numpy"])
def test_crc32c_and_masked_crc_equal_jax(with_native, monkeypatch):
    if with_native:
        assert native.get_lib() is not None and jax_native.get_lib() is not None
    else:
        monkeypatch.setattr(native, "get_lib", lambda: None)
        monkeypatch.setattr(jax_native, "get_lib", lambda: None)
        assert native.crc32c(b"x") is None
    for data in payloads(3)[:-1] + [b"123456789"]:
        assert tfrecord.crc32c(data) == jax_tfrecord.crc32c(data)
        assert tfrecord.masked_crc(data) == jax_tfrecord.masked_crc(data)
    assert tfrecord.crc32c(b"123456789") == 0xE3069283  # the Castagnoli check value


def test_native_library_builds_in_the_package_tree():
    assert native.get_lib() is not None
    assert native._BUILD_DIR.endswith(os.path.join("ron_tensorflow_tpu_torch", "_build"))
    assert any(n.startswith("crc32c_") and n.endswith(".so") for n in os.listdir(native._BUILD_DIR))


@pytest.mark.parametrize("with_native", [True, False], ids=["native", "numpy"])
def test_tfrecord_files_byte_equal_and_corruption_rejected(with_native, tmp_path, monkeypatch):
    if not with_native:
        monkeypatch.setattr(native, "get_lib", lambda: None)
    records = payloads(4)
    ours, theirs = tmp_path / "ours.tfrecord", tmp_path / "theirs.tfrecord"
    with tfrecord.TFRecordWriter(str(ours)) as w:
        for r in records:
            w.write(r)
    with jax_tfrecord.TFRecordWriter(str(theirs)) as w:
        for r in records:
            w.write(r)
    assert ours.read_bytes() == theirs.read_bytes()
    assert list(tfrecord.read_records(str(ours), verify_crc=True)) == records
    raw = bytearray(ours.read_bytes())
    for at in (9, 16 + 12, len(raw) - 1):  # a header's crc, the 1-byte payload of record 2, the last crc
        bad = bytearray(raw)
        bad[at] ^= 0x10
        path = tmp_path / f"bad_{at}.tfrecord"
        path.write_bytes(bytes(bad))
        with pytest.raises(IOError):
            list(tfrecord.read_records(str(path), verify_crc=True))


def test_shard_listing_equals_jax(tmp_path):
    for name in ("voc_2007_train_003.tfrecord", "voc_2012_train_000.tfrecord", "voc_2007_test_000.tfrecord",
                 "voc_2007_train_001.tfrecord", "other.txt"):
        (tmp_path / name).write_bytes(b"")
    pattern = "voc_20??_train_*.tfrecord"
    files = tfrecord.list_shards(str(tmp_path), pattern)
    assert files == jax_tfrecord.list_shards(str(tmp_path), pattern) and len(files) == 3
    for workers in (1, 2, 3, 5):
        for index in range(workers):
            assert (tfrecord.shard_for_worker(files, workers, index)
                    == jax_tfrecord.shard_for_worker(files, workers, index))
