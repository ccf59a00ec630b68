"""TFRecord container format: a dependency-free reader and writer.

A copy of `ron_tensorflow_tpu/data/tfrecord.py` (ref:
datasets/pascalvoc_to_tfrecords.py:191-230, datasets/pascalvoc_common.py:
55-95): records the port writes are byte-equal to the JAX package's and to
TensorFlow's. The TensorBoard writer frames its events with it.

Framing (per record): uint64 length | uint32 masked_crc32c(length) |
bytes data | uint32 masked_crc32c(data). CRC is Castagnoli (crc32c) with
TFRecord's rotation mask.
"""

from __future__ import annotations

import os
import struct
from typing import Iterable, Iterator, List, Optional

import numpy as np

_CRC_TABLE: Optional[np.ndarray] = None
_MASK_DELTA = 0xA282EAD8


def _crc_table() -> np.ndarray:
    global _CRC_TABLE
    if _CRC_TABLE is None:
        poly = 0x82F63B78  # reflected Castagnoli
        table = np.zeros(256, dtype=np.uint64)
        for i in range(256):
            crc = i
            for _ in range(8):
                crc = (crc >> 1) ^ (poly if crc & 1 else 0)
            table[i] = crc
        _CRC_TABLE = table
    return _CRC_TABLE


def crc32c(data: bytes) -> int:
    """Castagnoli CRC-32: native slice-by-8 C kernel (data/native.py, ~GB/s)
    with a pure-python table fallback."""
    from . import native

    fast = native.crc32c(data)
    if fast is not None:
        return fast
    try:  # zlib-speed path if the optional wheel exists
        import crc32c as _c  # type: ignore

        return _c.crc32c(data)
    except Exception:
        pass
    table = _crc_table()
    arr = np.frombuffer(data, dtype=np.uint8)
    crc = np.uint64(0xFFFFFFFF)
    tab = table
    for b in arr.tolist():
        crc = tab[(int(crc) ^ b) & 0xFF] ^ (crc >> np.uint64(8))
    return int(crc) ^ 0xFFFFFFFF


def masked_crc(data: bytes) -> int:
    crc = crc32c(data)
    return ((crc >> 15) | (crc << 17)) + _MASK_DELTA & 0xFFFFFFFF


class TFRecordWriter:
    """Write framed records to one file."""

    def __init__(self, path: str):
        self._f = open(path, "wb")

    def write(self, data: bytes) -> None:
        header = struct.pack("<Q", len(data))
        self._f.write(header)
        self._f.write(struct.pack("<I", masked_crc(header)))
        self._f.write(data)
        self._f.write(struct.pack("<I", masked_crc(data)))

    def close(self) -> None:
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def read_records(path: str, verify_crc: bool = False) -> Iterator[bytes]:
    """Iterate raw records of one shard.

    Native path: the whole shard is scanned (framing + BOTH masked CRCs
    verified — integrity checking is ~free in C, so it is always on) and
    payloads are sliced out. Falls back to the streaming python reader when
    no compiler is available.
    """
    from . import native

    if native.get_lib() is not None:
        with open(path, "rb") as f:
            buf = f.read()
        try:
            offsets, lengths = native.scan_records(buf, verify=True)
        except IOError as e:
            raise IOError(f"{path}: {e}") from None
        for off, length in zip(offsets.tolist(), lengths.tolist()):
            yield buf[off : off + length]
        return
    with open(path, "rb") as f:
        while True:
            header = f.read(8)
            if len(header) < 8:
                return
            (length,) = struct.unpack("<Q", header)
            (hcrc,) = struct.unpack("<I", f.read(4))
            data = f.read(length)
            (dcrc,) = struct.unpack("<I", f.read(4))
            if verify_crc:
                if masked_crc(header) != hcrc:
                    raise IOError(f"{path}: corrupt length header")
                if masked_crc(data) != dcrc:
                    raise IOError(f"{path}: corrupt record payload")
            yield data


def list_shards(dataset_dir: str, pattern_prefix: str) -> List[str]:
    """Sorted shard files matching a filename prefix (glob-lite)."""
    import fnmatch

    names = sorted(
        n for n in os.listdir(dataset_dir) if fnmatch.fnmatch(n, pattern_prefix)
    )
    return [os.path.join(dataset_dir, n) for n in names]


def shard_for_worker(files: Iterable[str], num_workers: int, worker_index: int) -> List[str]:
    """Deterministic per-worker file slice — the reference's replica input
    sharding (ref: datasets/pascalvoc_common.py:76-88): sorted list sliced
    [wi*N/W, (wi+1)*N/W)."""
    files = sorted(files)
    n = len(files)
    start = (worker_index * n) // num_workers
    end = ((worker_index + 1) * n) // num_workers
    return files[start:end]
