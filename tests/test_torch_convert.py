"""The port's VOC -> TFRecord converter (`data/convert.py`) against the JAX
package's: shards and encoded examples byte for byte equal."""

from pathlib import Path

import pytest

from ron_tensorflow_tpu.data import convert as jax_convert
from ron_tensorflow_tpu.data import voc as jax_voc

from ron_tensorflow_tpu_torch.data import convert, voc
from ron_tensorflow_tpu_torch.data.tfrecord import read_records

VOC = Path(__file__).resolve().parent / "fixtures" / "voc_mini" / "VOC2007"


def shard_bytes(directory):
    return {p.name: p.read_bytes() for p in sorted(Path(directory).glob("*.tfrecord"))}


@pytest.mark.parametrize("kw", [dict(), dict(samples_per_file=3), dict(shuffle_seed=4, samples_per_file=5),
                                dict(image_ids=["000004", "000001", "000007"], output_name="voc_2012_train")],
                         ids=["one-shard", "three-shards", "shuffled", "ids"])
def test_shards_byte_equal_to_jax(tmp_path, kw):
    n = convert.convert_voc(str(VOC), str(tmp_path / "port"), **{k: (list(v) if k == "image_ids" else v)
                                                                for k, v in kw.items()})
    m = jax_convert.convert_voc(str(VOC), str(tmp_path / "jax"), **{k: (list(v) if k == "image_ids" else v)
                                                                   for k, v in kw.items()})
    got, want = shard_bytes(tmp_path / "port"), shard_bytes(tmp_path / "jax")
    assert n == m == len(kw.get("image_ids", range(8)))
    assert got.keys() == want.keys() and got == want
    assert sum(1 for f in got for _ in read_records(str(tmp_path / "port" / f), verify_crc=True)) == n


def test_encode_example_byte_equal_to_jax():
    for xml in sorted((VOC / "Annotations").glob("*.xml")):
        data = (VOC / "JPEGImages" / f"{xml.stem}.jpg").read_bytes()
        assert (convert.encode_voc_example(data, voc.parse_annotation(str(xml)))
                == jax_convert.encode_voc_example(data, jax_voc.parse_annotation(str(xml))))
    assert convert.SAMPLES_PER_FILE == jax_convert.SAMPLES_PER_FILE
