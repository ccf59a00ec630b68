"""The port's TFRecord input pipeline (`data/pipeline.py`) against the JAX
package's on the same shards (the eight `voc_mini` images, converted by
the JAX converter): record parsing, the difficult policy, gt padding, the
sample order (shuffle on and off, several shards, two workers, two
epochs), and `batch_iterator`'s batches for every eval resize strategy,
with the cache, decode threads and a padded final batch. The JAX package
decodes through cv2 here and the port through its own decoder: the batches
are bit-equal, eval and train canvases alike."""

import itertools
from pathlib import Path

import numpy as np
import pytest

from ron_tensorflow_tpu.data import convert as jax_convert
from ron_tensorflow_tpu.data import example as jax_example
from ron_tensorflow_tpu.data import pipeline as jax_pipeline
from ron_tensorflow_tpu.data.tfrecord import TFRecordWriter as JaxTFRecordWriter
from ron_tensorflow_tpu.data.tfrecord import list_shards as jax_list_shards
from ron_tensorflow_tpu.data.tfrecord import read_records as jax_read_records

from ron_tensorflow_tpu_torch.data import pipeline
from ron_tensorflow_tpu_torch.data.tfrecord import read_records

VOC = Path(__file__).resolve().parent / "fixtures" / "voc_mini" / "VOC2007"
STRATEGIES = [None, "WARP_RESIZE", "CENTRAL_CROP", "PAD_AND_RESIZE"]


@pytest.fixture(scope="module")
def shards(tmp_path_factory):
    """The eight images in three shards (3 + 3 + 2 records)."""
    out = tmp_path_factory.mktemp("records")
    assert jax_convert.convert_voc(str(VOC), str(out), "voc_2007_train", samples_per_file=3) == 8
    files = jax_list_shards(str(out), "voc_2007_train_*.tfrecord")
    assert len(files) == 3
    return files


@pytest.fixture(scope="module")
def shapeless(tmp_path_factory, shards):
    """The same records without `image/shape`: the size comes from the JPEG."""
    out = tmp_path_factory.mktemp("shapeless")
    path = str(out / "voc_2007_train_000.tfrecord")
    with JaxTFRecordWriter(path) as w:
        for f in shards:
            for rec in jax_read_records(f):
                ex = jax_example.decode_example(rec)
                feats = {"image/encoded": jax_example.bytes_feature(ex["image/encoded"][0])}
                for key in ("ymin", "xmin", "ymax", "xmax"):
                    feats[f"image/object/bbox/{key}"] = jax_example.float_feature(ex[f"image/object/bbox/{key}"])
                for key in ("label", "difficult", "truncated"):
                    feats[f"image/object/bbox/{key}"] = jax_example.int64_feature(ex[f"image/object/bbox/{key}"])
                w.write(jax_example.encode_example(feats))
    return [path]


def assert_samples_equal(got, want):
    assert got.keys() == want.keys()
    for k in want:
        if isinstance(want[k], np.ndarray):
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        else:
            assert got[k] == want[k], k


def test_parse_difficult_policy_and_padding_match_jax(shards, shapeless):
    n_difficult = 0
    for f in shards + shapeless:
        for rec in read_records(f):
            got, want = pipeline.parse_voc_example(rec), jax_pipeline.parse_voc_example(rec)
            assert_samples_equal(got, want)
            n_difficult += int(want["difficult"].sum())
            for keep in (False, True):
                assert_samples_equal(pipeline._apply_difficult_policy(got, keep),
                                     jax_pipeline._apply_difficult_policy(want, keep))
            for max_boxes in (3, 56):  # truncating and padding
                assert_samples_equal(pipeline._pad_gt(got, max_boxes), jax_pipeline._pad_gt(want, max_boxes))
    assert n_difficult == 2  # 000003's last object, in both record sets
    everything_difficult = {**want, "difficult": np.ones_like(want["difficult"])}
    assert_samples_equal(pipeline._apply_difficult_policy(everything_difficult, False), everything_difficult)


@pytest.mark.parametrize("shuffle,buffer", [(False, 512), (True, 512), (True, 3)], ids=["ordered", "shuffled",
                                                                                      "small-buffer"])
@pytest.mark.parametrize("workers", [1, 2])
def test_sample_order_matches_jax(shards, shuffle, buffer, workers):
    for index in range(workers):
        kw = dict(shuffle=shuffle, shuffle_buffer=buffer, num_workers=workers, worker_index=index, seed=3)
        got = list(pipeline.iterate_samples(shards, pipeline.PipelineConfig(**kw), epochs=2))
        want = list(jax_pipeline.iterate_samples(shards, jax_pipeline.PipelineConfig(**kw), epochs=2))
        assert len(got) == len(want) > 0
        for g, w in zip(got, want):
            assert_samples_equal(g, w)
    with pytest.raises(ValueError, match="no input shards"):
        next(pipeline.iterate_samples([], pipeline.PipelineConfig()))


def batches(module, files, epochs=1, drop_remainder=False, **kw):
    return list(module.batch_iterator(files, module.PipelineConfig(**kw), epochs=epochs,
                                      drop_remainder=drop_remainder))


def assert_batches_equal(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in w:
            assert g[k].dtype == w[k].dtype and g[k].shape == w[k].shape, k
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


CASES = [
    dict(batch_size=3, working_shape=(40, 56), max_boxes=6, shuffle=False, keep_difficult=True,
         cache_decoded=False, decode_workers=0),
    dict(batch_size=3, working_shape=(40, 56), max_boxes=6, shuffle=True, seed=5, cache_decoded=True,
         decode_workers=3, output_dtype="uint8"),
]


@pytest.mark.parametrize("strategy", STRATEGIES, ids=lambda s: s or "train")
@pytest.mark.parametrize("case", range(len(CASES)))
def test_batch_iterator_matches_jax(shards, strategy, case):
    """8 samples in batches of 3: the last one padded, its rows masked."""
    kw = dict(CASES[case], eval_resize=strategy)
    got = batches(pipeline, shards, epochs=2 if kw["cache_decoded"] else 1, **kw)
    want = batches(jax_pipeline, shards, epochs=2 if kw["cache_decoded"] else 1, **kw)
    assert_batches_equal(got, want)
    n = 16 if kw["cache_decoded"] else 8
    assert len(got) == -(-n // 3) and int(sum(b["sample_valid"].sum() for b in got)) == n
    assert not got[-1]["sample_valid"][-1] and not got[-1]["gt_valid"][-1].any()
    dropped = batches(pipeline, shards, drop_remainder=True, **kw)
    assert len(dropped) == 2 and all(b["sample_valid"].all() for b in dropped)


@pytest.mark.parametrize("strategy", ["CENTRAL_CROP", "PAD_AND_RESIZE"])
def test_records_without_shape_take_the_jpeg_size(shapeless, strategy):
    kw = dict(batch_size=4, working_shape=(48, 48), shuffle=False, eval_resize=strategy, decode_workers=0)
    assert_batches_equal(batches(pipeline, shapeless, **kw), batches(jax_pipeline, shapeless, **kw))


@pytest.mark.parametrize("strategy", STRATEGIES, ids=lambda s: s or "train")
def test_native_backend_batches(shards, strategy):
    """The port's own decoder and resize on an upscaling canvas, two decode
    threads: bit-equal to JAX's batches decoded by cv2."""
    kw = dict(batch_size=4, working_shape=(64, 96), shuffle=True, seed=1, eval_resize=strategy, decode_workers=2)
    assert_batches_equal(batches(pipeline, shards, **kw), batches(jax_pipeline, shards, **kw))


def test_unbatchable_strategy_raises(shards):
    with pytest.raises(ValueError, match="NONE"):
        next(pipeline.batch_iterator(shards, pipeline.PipelineConfig(eval_resize="NONE")))


def test_prefetch_iterator_passes_batches_and_errors(shards):
    cfg = pipeline.PipelineConfig(batch_size=2, working_shape=(32, 32), shuffle=False)
    got = list(pipeline.PrefetchIterator(pipeline.batch_iterator(shards, cfg, epochs=1), depth=2))
    assert len(got) == 4

    def failing():
        yield from itertools.islice(pipeline.batch_iterator(shards, cfg, epochs=1), 1)
        raise OSError("shard vanished")

    it = pipeline.PrefetchIterator(failing())
    next(it)
    with pytest.raises(OSError, match="vanished"):
        next(it)


def test_config_fields_match_jax():
    """Every field of JAX's, `prefetch` and `grain_workers` included, with
    the same defaults."""
    import dataclasses

    got = {f.name: f.default for f in dataclasses.fields(pipeline.PipelineConfig)}
    want = {f.name: f.default for f in dataclasses.fields(jax_pipeline.PipelineConfig)}
    assert got == want


def test_make_batches_first_batch_matches_the_card_reference(tmp_path):
    """chip_smoke.py's records tree (the eight images under 264 ids in two
    shards) through the port's converter and the trainer's pipeline: the
    first batch equals JAX's in voc_mini_ref.npz, which phase "records"
    holds the card host's run to."""
    import chip_smoke

    from ron_tensorflow_tpu_torch.data import convert
    from ron_tensorflow_tpu_torch.data.tfrecord import list_shards

    ref = np.load(Path(__file__).resolve().parent / "fixtures" / "voc_mini_ref.npz")
    for year, name in chip_smoke.repeated_vocdevkit(VOC, tmp_path / "voc"):
        convert.convert_voc(str(year), str(tmp_path / "records"), name)
    files = list_shards(str(tmp_path / "records"), chip_smoke.RECORD_PATTERN)
    assert [Path(f).name for f in files] == ref["batch/shards"].tolist()
    cfg = pipeline.PipelineConfig(batch_size=chip_smoke.BATCH_SIZE, working_shape=(512, 512), max_boxes=56,
                                  shuffle=True, keep_difficult=False, seed=chip_smoke.BATCH_SEED, cache_decoded=True,
                                  output_dtype="uint8")
    first = next(pipeline.batch_iterator(files, cfg, epochs=1))
    assert sum(1 for f in files for _ in read_records(f)) == chip_smoke.RECORD_COUNT
    for k in ("image01", "gt_labels", "gt_boxes", "gt_valid", "gt_difficult", "sample_valid"):
        np.testing.assert_array_equal(first[k], ref[f"batch/{k}"], err_msg=k)
