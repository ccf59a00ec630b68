"""Minimal protobuf `tf.train.Example` wire-format codec.

A copy of `ron_tensorflow_tpu/data/example.py`. Its varint and
length-delimited primitives also serve the TF checkpoint reader, the Caffe
importer and the TensorBoard writer.

Encodes/decodes exactly the subset of the Example proto the VOC schema uses
(bytes_list / float_list / int64_list features), byte-compatible with
TensorFlow's serialization, without importing TF or generated proto code.

Wire layout:
  Example      { Features features = 1; }
  Features     { map<string, Feature> feature = 1; }   // repeated map entry
  map entry    { string key = 1; Feature value = 2; }
  Feature      { oneof: BytesList = 1 | FloatList = 2 | Int64List = 3 }
  BytesList    { repeated bytes value = 1; }
  FloatList    { repeated float value = 1 [packed]; }
  Int64List    { repeated int64 value = 1 [packed]; }
"""

from __future__ import annotations

import struct
from typing import Dict, List, Sequence, Union

FeatureValue = Union[bytes, List[bytes], List[int], List[float]]


def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _tag(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


def _len_delimited(field: int, payload: bytes) -> bytes:
    return _tag(field, 2) + _varint(len(payload)) + payload


def _encode_bytes_list(values: Sequence[bytes]) -> bytes:
    body = b"".join(_len_delimited(1, v) for v in values)
    return _len_delimited(1, body)  # Feature.bytes_list = 1


def _encode_float_list(values: Sequence[float]) -> bytes:
    packed = struct.pack(f"<{len(values)}f", *values)
    body = _len_delimited(1, packed)  # packed repeated float
    return _len_delimited(2, body)  # Feature.float_list = 2


def _encode_int64_list(values: Sequence[int]) -> bytes:
    packed = b"".join(_varint(v & 0xFFFFFFFFFFFFFFFF) for v in values)
    body = _len_delimited(1, packed)
    return _len_delimited(3, body)  # Feature.int64_list = 3


def bytes_feature(value: Union[bytes, Sequence[bytes]]) -> bytes:
    if isinstance(value, bytes):
        value = [value]
    return _encode_bytes_list(list(value))


def float_feature(value: Union[float, Sequence[float]]) -> bytes:
    if isinstance(value, (int, float)):
        value = [value]
    return _encode_float_list(list(value))


def int64_feature(value: Union[int, Sequence[int]]) -> bytes:
    if isinstance(value, int):
        value = [value]
    return _encode_int64_list(list(value))


def encode_example(features: Dict[str, bytes]) -> bytes:
    """features: name -> already-encoded Feature message bytes."""
    entries = []
    for key in features:
        entry = _len_delimited(1, key.encode()) + _len_delimited(2, features[key])
        entries.append(_len_delimited(1, entry))  # Features.feature map entry
    features_msg = b"".join(entries)
    return _len_delimited(1, features_msg)  # Example.features = 1


# --------------------------------------------------------------------------- #
# Decoding
# --------------------------------------------------------------------------- #


def _read_varint(buf: bytes, pos: int):
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _iter_fields(buf: bytes, start: int = 0, end=None):
    end = len(buf) if end is None else end
    pos = start
    while pos < end:
        key, pos = _read_varint(buf, pos)
        field, wire = key >> 3, key & 7
        if wire == 0:
            val, pos = _read_varint(buf, pos)
            yield field, wire, val
        elif wire == 2:
            length, pos = _read_varint(buf, pos)
            yield field, wire, buf[pos : pos + length]
            pos += length
        elif wire == 5:
            yield field, wire, buf[pos : pos + 4]
            pos += 4
        elif wire == 1:
            yield field, wire, buf[pos : pos + 8]
            pos += 8
        else:
            raise ValueError(f"unsupported wire type {wire}")


def _decode_feature(buf: bytes) -> FeatureValue:
    for field, _, val in _iter_fields(buf):
        if field == 1:  # BytesList
            return [v for f, _, v in _iter_fields(val) if f == 1]
        if field == 2:  # FloatList (packed or not)
            floats: List[float] = []
            for f, wire, v in _iter_fields(val):
                if f != 1:
                    continue
                if wire == 2:
                    floats.extend(struct.unpack(f"<{len(v) // 4}f", v))
                else:
                    floats.append(struct.unpack("<f", v)[0])
            return floats
        if field == 3:  # Int64List (packed or not)
            ints: List[int] = []
            for f, wire, v in _iter_fields(val):
                if f != 1:
                    continue
                if wire == 2:
                    pos = 0
                    while pos < len(v):
                        n, pos = _read_varint(v, pos)
                        if n >= 1 << 63:
                            n -= 1 << 64
                        ints.append(n)
                else:
                    n = v
                    if n >= 1 << 63:
                        n -= 1 << 64
                    ints.append(n)
            return ints
    return []


def decode_example(buf: bytes) -> Dict[str, FeatureValue]:
    """Serialized Example -> {feature name: python list}."""
    out: Dict[str, FeatureValue] = {}
    for field, _, val in _iter_fields(buf):
        if field != 1:
            continue
        for f2, _, entry in _iter_fields(val):
            if f2 != 1:
                continue
            key = None
            feature = None
            for f3, _, v3 in _iter_fields(entry):
                if f3 == 1:
                    key = v3.decode()
                elif f3 == 2:
                    feature = v3
            if key is not None and feature is not None:
                out[key] = _decode_feature(feature)
    return out
