"""ctypes loader for the native data-path helpers (crc32c + record scan).

A copy of `ron_tensorflow_tpu/data/native.py`, but for where the library is
built: `_native/crc32c.c` is compiled once with the host C compiler (`$CC`,
else `cc`) into the package's `_build/` directory (gitignored, shared with
the CUDA kernels' build), named by a hash of the source so that an edit
rebuilds it, and loaded through ctypes. Every entry point returns None
when no compiler or library is found, and `data/tfrecord.py` then computes
the CRC with its numpy table. A host helper, not a kernel of the card.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
from typing import Optional

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "_native", "crc32c.c")
_BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build")
_lib: Optional[ctypes.CDLL] = None
_tried = False


def _build_and_load() -> Optional[ctypes.CDLL]:
    with open(_SRC, "rb") as f:
        src = f.read()
    tag = hashlib.sha256(src).hexdigest()[:16]
    cache_dir = _BUILD_DIR
    so_path = os.path.join(cache_dir, f"crc32c_{tag}.so")
    if not os.path.exists(so_path):
        os.makedirs(cache_dir, exist_ok=True)
        cc = os.environ.get("CC", "cc")
        with tempfile.NamedTemporaryFile(
            suffix=".so", dir=cache_dir, delete=False
        ) as tmp:
            tmp_path = tmp.name
        try:
            subprocess.run(
                [cc, "-O3", "-shared", "-fPIC", "-o", tmp_path, _SRC],
                check=True,
                capture_output=True,
                timeout=60,
            )
            os.replace(tmp_path, so_path)  # atomic vs concurrent builders
        except (OSError, subprocess.SubprocessError):
            try:
                os.unlink(tmp_path)
            except OSError:
                pass
            return None
    try:
        lib = ctypes.CDLL(so_path)
    except OSError:
        return None
    lib.crc32c.restype = ctypes.c_uint32
    lib.crc32c.argtypes = [ctypes.c_char_p, ctypes.c_size_t, ctypes.c_uint32]
    lib.scan_records.restype = ctypes.c_int64
    lib.scan_records.argtypes = [
        ctypes.c_char_p,
        ctypes.c_int64,
        ctypes.c_int,
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int64,
    ]
    return lib


def get_lib() -> Optional[ctypes.CDLL]:
    """The native library, or None when unavailable (no compiler)."""
    global _lib, _tried
    if not _tried:
        _tried = True
        try:
            _lib = _build_and_load()
        except Exception:
            _lib = None
    return _lib


def crc32c(data: bytes) -> Optional[int]:
    """Native Castagnoli CRC-32, or None if the library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    return int(lib.crc32c(data, len(data), 0))


def scan_records(buf: bytes, verify: bool = True):
    """Scan a whole TFRecord shard held in memory.

    Returns (offsets, lengths) int64 arrays of the record payload spans, or
    None if the native library is unavailable. Raises IOError on corruption
    (CRC mismatch or truncation).
    """
    lib = get_lib()
    if lib is None:
        return None
    # upper bound: every record is at least 16 framing bytes
    cap = max(len(buf) // 16, 1)
    offsets = np.empty((cap,), np.int64)
    lengths = np.empty((cap,), np.int64)
    n = lib.scan_records(
        buf,
        len(buf),
        1 if verify else 0,
        offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        lengths.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        cap,
    )
    if n < 0:
        raise IOError(f"corrupt TFRecord framing at byte {-n - 1}")
    return offsets[:n], lengths[:n]
