"""The port's TensorBoard writer against the JAX package's: with the wall
time pinned, the same calls give the same bytes (an image's PNG, which the
port writes with its own encoder and JAX through PIL, gives the same
pixels); the port's decoder reads them back with every record's CRCs
verified, and TensorFlow's own event reader agrees where TensorFlow is
installed."""

import io
import os
import sys
import time

import numpy as np
import pytest

from ron_tensorflow_tpu.utils.tensorboard import TensorBoardWriter as JaxWriter

from ron_tensorflow_tpu_torch.data.png import decode_png
from ron_tensorflow_tpu_torch.utils.tensorboard import TensorBoardWriter, read_events

WALL = 1700000000.25


def write(cls, logdir, with_image):
    w = cls(str(logdir))
    w.scalar("loss/total", 3.25, step=10)
    rng = np.random.default_rng(0)
    w.scalars({f"loss/part_{i}": float(v) for i, v in enumerate(rng.standard_normal(6))} | {"skip": "text"}, step=20)
    w.scalars({"a": np.float32(1.5), "b": 2}, step=2 ** 40, prefix="train")
    if with_image:
        img = rng.integers(0, 256, (8, 6, 3), np.uint8)
        w.image("debug/gt", img, step=30)
    w.close()
    return w.path


@pytest.mark.parametrize("with_image", [False, True], ids=["scalars", "scalars+image"])
def test_event_files_equal_jax_and_decode(with_image, tmp_path, monkeypatch):
    monkeypatch.setattr(time, "time", lambda: WALL)
    ours = write(TensorBoardWriter, tmp_path / "ours", with_image)
    theirs = write(JaxWriter, tmp_path / "theirs", with_image)
    assert os.path.basename(ours) == os.path.basename(theirs)
    if not with_image:
        with open(ours, "rb") as a, open(theirs, "rb") as b:
            assert a.read() == b.read()
    else:  # every event equal but the image's PNG bytes, whose pixels are
        got, want = read_events(ours), read_events(theirs)
        pngs = [[im[2] for e in ev for im in e["images"].values()] for ev in (got, want)]
        for ev in (got, want):
            for e in ev:
                e["images"] = {tag: im[:2] for tag, im in e["images"].items()}
        assert got == want and len(pngs[0]) == len(pngs[1]) == 1
        np.testing.assert_array_equal(decode_png(pngs[0][0]), decode_png(pngs[1][0]))

    events = read_events(ours)
    assert events[0]["file_version"] == "brain.Event:2" and all(e["wall_time"] == WALL for e in events)
    scalars = {(e["step"], tag): v for e in events for tag, v in e["scalars"].items()}
    rng = np.random.default_rng(0)
    want = {(10, "loss/total"): 3.25, (2 ** 40, "train/a"): 1.5, (2 ** 40, "train/b"): 2.0}
    want.update({(20, f"loss/part_{i}"): float(np.float32(v)) for i, v in enumerate(rng.standard_normal(6))})
    assert scalars == want  # float32 values; the non-numeric one dropped
    images = [(e["step"], tag, im) for e in events for tag, im in e["images"].items()]
    assert len(images) == int(with_image)
    if with_image:
        from PIL import Image

        step, tag, (h, w, png) = images[0]
        assert (step, tag, h, w) == (30, "debug/gt", 8, 6)
        np.testing.assert_array_equal(np.asarray(Image.open(io.BytesIO(png))),
                                      rng.integers(0, 256, (8, 6, 3), np.uint8))


def test_event_file_readable_by_tensorflow(tmp_path):
    tf = pytest.importorskip("tensorflow")
    path = write(TensorBoardWriter, tmp_path, with_image=False)
    ours = {(e["step"], tag): v for e in read_events(path) for tag, v in e["scalars"].items()}
    theirs = {(ev.step, v.tag): v.simple_value for ev in tf.compat.v1.train.summary_iterator(path)
              for v in ev.summary.value}
    assert ours == theirs and len(ours) == 9


def test_corrupt_event_file_is_rejected(tmp_path):
    path = write(TensorBoardWriter, tmp_path, with_image=False)
    raw = bytearray(open(path, "rb").read())
    raw[-6] ^= 0x01  # inside the last event's payload
    open(path, "wb").write(bytes(raw))
    with pytest.raises(IOError):
        read_events(path)


def test_png_needs_pil_only_when_an_image_is_written(tmp_path, monkeypatch):
    """Not even then: with PIL and cv2 unimportable, an image summary is
    written by the port's own PNG encoder and reads back."""
    monkeypatch.setitem(sys.modules, "PIL", None)
    monkeypatch.setitem(sys.modules, "cv2", None)
    img = np.random.default_rng(2).integers(0, 256, (5, 7, 3), np.uint8)
    w = TensorBoardWriter(str(tmp_path))
    w.scalars({"x": 1.0}, step=1)
    w.image("debug/gt", img, step=1)
    w.close()
    events = read_events(w.path)
    assert [e["scalars"] for e in events] == [{}, {"x": 1.0}, {}]
    h, wd, png = events[2]["images"]["debug/gt"]
    assert (h, wd) == (5, 7)
    np.testing.assert_array_equal(decode_png(png), img)
