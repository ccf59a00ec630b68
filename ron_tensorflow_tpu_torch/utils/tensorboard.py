"""Dependency-free TensorBoard event-file writer.

A copy of `ron_tensorflow_tpu/utils/tensorboard.py` (ref: ron_net.py:331-372,
ssd_vgg_preprocessing.py:86-94, eval_ron_network.py:259-324): Event and
Summary protos hand-encoded with the varint and length-delimited primitives
of `data/example.py`, framed as TFRecords (`data/tfrecord.py`) into
`events.out.tfevents.*` files that TensorBoard reads. Image summaries are
PNG, written by the port's own encoder (`data/png.py::encode_png`, the
standard zlib): no PIL.

Proto schema (tensorflow/core/util/event.proto, summary.proto):
  Event   { double wall_time=1; int64 step=2; string file_version=3;
            Summary summary=5; }
  Summary { repeated Value value=1; }
  Value   { string tag=1; float simple_value=2; Image image=4; }
  Image   { int32 height=1; int32 width=2; int32 colorspace=3;
            bytes encoded_image_string=4; }
"""

from __future__ import annotations

import os
import socket
import struct
import time
from typing import Optional, Union

import numpy as np

from ..data.example import _iter_fields, _len_delimited, _tag, _varint
from ..data.png import encode_png
from ..data.tfrecord import TFRecordWriter, read_records


def _double_field(field: int, value: float) -> bytes:
    return _tag(field, 1) + struct.pack("<d", value)


def _float_field(field: int, value: float) -> bytes:
    return _tag(field, 5) + struct.pack("<f", value)


def _varint_field(field: int, value: int) -> bytes:
    return _tag(field, 0) + _varint(value)


def _scalar_value(tag: str, value: float) -> bytes:
    body = _len_delimited(1, tag.encode()) + _float_field(2, float(value))
    return _len_delimited(1, body)  # Summary.value


def _image_value(tag: str, png: bytes, height: int, width: int) -> bytes:
    img = (
        _varint_field(1, height)
        + _varint_field(2, width)
        + _varint_field(3, 3)  # RGB
        + _len_delimited(4, png)
    )
    body = _len_delimited(1, tag.encode()) + _len_delimited(4, img)
    return _len_delimited(1, body)


def _event(step: int, summary_values: bytes = b"", file_version: Optional[str] = None) -> bytes:
    ev = _double_field(1, time.time()) + _varint_field(2, int(step))
    if file_version is not None:
        ev += _len_delimited(3, file_version.encode())
    if summary_values:
        ev += _len_delimited(5, summary_values)  # Summary { repeated value }
    return ev


class TensorBoardWriter:
    """Minimal SummaryWriter: scalars + images, one event file per run."""

    def __init__(self, logdir: str):
        os.makedirs(logdir, exist_ok=True)
        host = socket.gethostname()
        self.path = os.path.join(
            logdir, f"events.out.tfevents.{int(time.time())}.{host}"
        )
        self._w = TFRecordWriter(self.path)
        self._w.write(_event(0, file_version="brain.Event:2"))
        self._flush()

    def _flush(self):
        self._w._f.flush()

    def scalar(self, tag: str, value: float, step: int) -> None:
        self._w.write(_event(step, _scalar_value(tag, value)))

    def scalars(self, metrics, step: int, prefix: Optional[str] = None) -> None:
        vals = b""
        for k, v in metrics.items():
            try:
                f = float(v)
            except (TypeError, ValueError):
                continue
            vals += _scalar_value(f"{prefix}/{k}" if prefix else k, f)
        if vals:
            self._w.write(_event(step, vals))
        self._flush()

    def image(
        self, tag: str, image: Union[np.ndarray, bytes], step: int,
        height: Optional[int] = None, width: Optional[int] = None,
    ) -> None:
        """image: uint8 [H,W,3] array, or already-encoded PNG bytes (then
        pass height/width)."""
        if isinstance(image, np.ndarray):
            height, width = image.shape[:2]
            image = encode_png(image)
        self._w.write(_event(step, _image_value(tag, image, height, width)))
        self._flush()

    def close(self) -> None:
        self._w.close()


def _decode_value(buf: bytes, event: dict) -> None:
    tag, simple, image = "", None, None
    for field, _, val in _iter_fields(buf):
        if field == 1:
            tag = val.decode()
        elif field == 2:
            (simple,) = struct.unpack("<f", val)
        elif field == 4:
            img = {f: v for f, _, v in _iter_fields(val)}
            image = (img.get(1, 0), img.get(2, 0), img.get(4, b""))
    if simple is not None:
        event["scalars"][tag] = simple
    if image is not None:
        event["images"][tag] = image


def read_events(path: str):
    """Decode an event file written by `TensorBoardWriter`, both masked CRCs
    of every record verified: a list of dicts with `wall_time`, `step`,
    `file_version` (or None), `scalars` {tag: float32 value} and `images`
    {tag: (height, width, PNG bytes)}."""
    events = []
    for record in read_records(path, verify_crc=True):
        ev = {"wall_time": 0.0, "step": 0, "file_version": None, "scalars": {}, "images": {}}
        for field, _, val in _iter_fields(record):
            if field == 1:
                (ev["wall_time"],) = struct.unpack("<d", val)
            elif field == 2:
                ev["step"] = val
            elif field == 3:
                ev["file_version"] = val.decode()
            elif field == 5:
                for f2, _, v2 in _iter_fields(val):
                    if f2 == 1:
                        _decode_value(v2, ev)
        events.append(ev)
    return events
