"""Build and bind the port's CUDA kernels.

All sources under `csrc/` are compiled by ONE plain `nvcc` call into a
shared library with a C interface (no PyTorch headers, no CUTLASS), which
is loaded with ctypes. The build runs at first use, on the GPU host,
into `_build/` (listed in .gitignore); its name carries a hash of the
sources and flags, so an edited source is rebuilt.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
SOURCES = ("nms_fixpoint.cu", "fused_vgg_block1.cu")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)
BUILD_TIMEOUT_S = 600

_P = ctypes.c_void_p
_I = ctypes.c_int
# name -> argtypes of each extern "C" launcher; every launcher returns the
# cudaError_t of its launch (0 = success).
SIGNATURES = {
    # scores, boxes, keep, rows, k, threshold, union_mode, stream
    "nms_fixpoint_keep_mask": (_P, _P, _P, _I, _I, ctypes.c_float, _I, _P),
    # x, w1, b1, w2, b2, out, batch, height, width, stream
    "fused_vgg_block1": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _P),
}


def nvcc_path() -> str:
    candidate = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (looked in $CUDA_HOME/bin and on PATH)")
    return found


def library_path() -> Path:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES:
        digest.update((CSRC_DIR / name).read_bytes())
    return BUILD_DIR / f"libron_kernels_{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile every source with one nvcc call; returns the library path.
    Writes to a temporary name first, so concurrent processes never load a
    half-written file."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, *(str(CSRC_DIR / s) for s in SOURCES)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=BUILD_TIMEOUT_S)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{proc.stdout}\n{proc.stderr}"
            )
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return out


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.ron_cuda_error_string.argtypes = (ctypes.c_int,)
    lib.ron_cuda_error_string.restype = ctypes.c_char_p
    return lib


def timed_build() -> float:
    """Seconds taken to build and load the library in this process."""
    t0 = time.perf_counter()
    library()
    return time.perf_counter() - t0


def check(name: str, err: int) -> None:
    """Raise if a launcher returned a CUDA error."""
    if err != 0:
        what = library().ron_cuda_error_string(err).decode()
        raise RuntimeError(f"CUDA kernel {name} failed to launch: cudaError {err} ({what})")
