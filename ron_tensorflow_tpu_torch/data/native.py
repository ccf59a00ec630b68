"""ctypes loader for the native data-path helpers (crc32c + record scan).

A copy of `ron_tensorflow_tpu/data/native.py`, but for where the library is
built: `_native/crc32c.c` is compiled once with the host C compiler (`$CC`,
else `cc`) into the package's `_build/` directory (gitignored, shared with
the CUDA kernels' build), named by a hash of the source so that an edit
rebuilds it, and loaded through ctypes. Every entry point returns None
when no compiler or library is found, and `data/tfrecord.py` then computes
the CRC with its numpy table. A host helper, not a kernel of the card.
`build_shared` also builds the JPEG decoder (`data/jpeg.py`), which has no
fallback and lets a failed build raise.
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


def build_shared(src: str, stem: str, flags=()) -> str:
    """Compile the C source `src` into `_build/<stem>_<hash>.so` with the
    host C compiler, unless that file is there already; returns its path.
    Raises OSError or subprocess.SubprocessError when the build fails."""
    with open(src, "rb") as f:
        text = f.read()
    tag = hashlib.sha256(text + " ".join(flags).encode()).hexdigest()[:16]
    so_path = os.path.join(_BUILD_DIR, f"{stem}_{tag}.so")
    if os.path.exists(so_path):
        return so_path
    os.makedirs(_BUILD_DIR, exist_ok=True)
    cc = os.environ.get("CC", "cc")
    with tempfile.NamedTemporaryFile(suffix=".so", dir=_BUILD_DIR, delete=False) as tmp:
        tmp_path = tmp.name
    try:
        proc = subprocess.run([cc, "-O3", "-shared", "-fPIC", *flags, "-o", tmp_path, src, "-lm"],
                              capture_output=True, text=True, timeout=120)
        if proc.returncode:
            raise subprocess.SubprocessError(f"{cc} failed on {src}:\n{proc.stderr}")
        os.replace(tmp_path, so_path)  # atomic against concurrent builds
    finally:
        if os.path.exists(tmp_path):
            os.unlink(tmp_path)
    return so_path


def _build_and_load() -> Optional[ctypes.CDLL]:
    try:
        so_path = build_shared(_SRC, "crc32c")
    except (OSError, subprocess.SubprocessError):
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
