"""The port's classification records, dataset and preprocessing factories,
split registry and host whitening (`data/classification.py`,
`data/factory.py`, `data/voc.py::SplitInfo`/`SPLITS`,
`data/preprocess.py::whiten_np`) against the JAX package's, on the CPU:
the same records byte for byte, the same registries, shard lists and
configs, `whiten_np` bit for bit."""

import dataclasses

import numpy as np
import pytest

from ron_tensorflow_tpu.data import classification as jax_cls
from ron_tensorflow_tpu.data import factory as jax_factory
from ron_tensorflow_tpu.data import voc as jax_voc
from ron_tensorflow_tpu.data.preprocess import whiten_np as jax_whiten_np

from ron_tensorflow_tpu_torch.data import classification, factory, voc
from ron_tensorflow_tpu_torch.data.preprocess import whiten_np
from ron_tensorflow_tpu_torch.data.tfrecord import TFRecordWriter, read_records


def as_tuples(registry):
    return {name: {split: dataclasses.astuple(info) for split, info in splits.items()}
            for name, splits in registry.items()}


def test_split_registries_equal_jax():
    assert as_tuples(voc.SPLITS) == as_tuples(jax_voc.SPLITS)
    assert as_tuples(classification.CLASSIFICATION_SPLITS) == as_tuples(jax_cls.CLASSIFICATION_SPLITS)
    info = voc.SplitInfo("train", "x_*.tfrecord", 3)
    assert dataclasses.astuple(info) == dataclasses.astuple(jax_voc.SplitInfo("train", "x_*.tfrecord", 3))
    with pytest.raises(dataclasses.FrozenInstanceError):
        info.num_samples = 4


@pytest.mark.parametrize("label,fmt", [(0, b"JPEG"), (42, b"JPEG"), (999, b"PNG"), (2 ** 31 - 1, b"JPEG")])
def test_classification_records_equal_jax(tmp_path, label, fmt):
    data = bytes(np.random.default_rng(label % 97).integers(0, 256, 300, dtype=np.uint8))
    rec = classification.encode_classification_example(data, label, fmt)
    assert rec == jax_cls.encode_classification_example(data, label, fmt)
    for parse in (classification.parse_classification_example, jax_cls.parse_classification_example):
        out = parse(rec)
        assert out["jpeg"] == data and out["label"] == np.int32(label) and isinstance(out["label"], np.int32)
    # through a TFRecord shard, read back by both packages' parsers
    path = str(tmp_path / "cifar10_train_000.tfrecord")
    with TFRecordWriter(path) as w:
        w.write(rec)
    (back,) = list(read_records(path, verify_crc=True))
    assert jax_cls.parse_classification_example(back)["jpeg"] == data


def make_shards(root, names):
    root.mkdir(parents=True, exist_ok=True)
    for n in names:
        (root / n).write_bytes(b"")
    return str(root)


@pytest.mark.parametrize("workers", [1, 2, 3, 5])
def test_get_dataset_equals_jax(tmp_path, workers):
    d = make_shards(tmp_path, [f"voc_2007_train_{i:03d}.tfrecord" for i in range(7)]
                    + ["voc_2012_train_000.tfrecord", "voc_2007_test_000.tfrecord", "other.txt"])
    for name, split in (("pascalvoc_2007", "train"), ("pascalvoc_2007", "test"), ("pascalvoc_2007_2012", "train"),
                        ("pascalvoc_2012", "train")):
        for wi in range(workers):
            info, files = factory.get_dataset(name, split, d, workers, wi)
            jinfo, jfiles = jax_factory.get_dataset(name, split, d, workers, wi)
            assert dataclasses.astuple(info) == dataclasses.astuple(jinfo) and files == jfiles
    # the workers' slices cover the shards once
    slices = [factory.get_dataset("pascalvoc_2007", "train", d, workers, wi)[1] for wi in range(workers)]
    assert sorted(sum(slices, [])) == factory.get_dataset("pascalvoc_2007", "train", d)[1]


@pytest.mark.parametrize("args,error", [(("nope", "train"), ValueError), (("pascalvoc_2007", "val"), ValueError),
                                        (("pascalvoc_2012", "train"), FileNotFoundError)])
def test_get_dataset_errors_equal_jax(tmp_path, args, error):
    d = make_shards(tmp_path, ["voc_2007_train_000.tfrecord"])
    with pytest.raises(error) as got:
        factory.get_dataset(*args, d)
    with pytest.raises(error) as want:
        jax_factory.get_dataset(*args, d)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("name", ["ron_320_vgg", "ron_320_vgg_heavy", "ssd_300_vgg", "ssd_512_vgg", "ron_tiny_vgg"])
@pytest.mark.parametrize("out_shape", [None, (128, 96)])
def test_get_preprocessing_equals_jax(name, out_shape):
    cfg = factory.get_preprocessing(name, out_shape)
    jcfg = jax_factory.get_preprocessing(name, out_shape)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert isinstance(cfg.out_shape, tuple)


def test_get_preprocessing_unknown_name():
    with pytest.raises(ValueError, match="unknown preprocessing") as got:
        factory.get_preprocessing("inception_v3")
    with pytest.raises(ValueError) as want:
        jax_factory.get_preprocessing("inception_v3")
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("dtype", [np.float32, np.float64, np.uint8])
def test_whiten_np_equals_jax(dtype):
    rng = np.random.default_rng(0)
    x = rng.uniform(0, 1, (2, 5, 7, 3)) if dtype != np.uint8 else rng.integers(0, 2, (2, 5, 7, 3))
    x = x.astype(dtype)
    got, want = whiten_np(x), jax_whiten_np(x)
    assert got.dtype == want.dtype == np.float32 and np.array_equal(got, want)
