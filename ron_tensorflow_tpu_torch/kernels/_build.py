"""Build and bind the port's CUDA kernels.

All sources under `csrc/` are compiled by ONE plain `nvcc` call into a
shared library with a C interface (no PyTorch headers, no CUTLASS), which
is loaded with ctypes. The build runs at first use, on the GPU host,
into `_build/` (listed in .gitignore); its name carries a hash of the
sources, headers and flags, so an edited source is rebuilt. ptxas's
report (registers, spills) of every kernel is kept beside the library
(`build_log_path`).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
SOURCES = ("nms_greedy.cu", "fused_vgg_block1.cu", "conv3x3_relu_pool2.cu")
HEADERS = ("conv3x3_mma.cuh",)  # the tensor-core conv mainloop of K-B, K-D and K-E
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
BUILD_TIMEOUT_S = 600

_P = ctypes.c_void_p
_I = ctypes.c_int
# name -> argtypes of each extern "C" launcher; every launcher returns the
# cudaError_t of its launch (0 = success).
SIGNATURES = {
    # scores, boxes, keep, steps (null or int32 [rows]), rows, k, threshold, union_mode, stream
    "nms_fixpoint_keep_mask": (_P, _P, _P, _P, _I, _I, ctypes.c_float, _I, _P),
    # scores, boxes, keep, steps, rows, k, threshold, keep_top_k, union_mode, stream
    "nms_scan_keep_mask": (_P, _P, _P, _P, _I, _I, ctypes.c_float, _I, _I, _P),
    # x, w1, b1, w2, b2, out, batch, height, width, stream
    "fused_vgg_block1": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _P),
    # x, w1, b1, w2, b2, out, batch, height, width, cin, c, stream
    "fused_vgg_block2": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    # x, w, b, out, batch, height, width, cin, cout, stream
    "fused_stem_conv_relu_pool2": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    # x, w, b, out, batch, height, width, cin, cout, out_bf16, stream
    "fused_conv3x3_relu_pool2": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
    # the NMS cluster kernel's layout: CTAs a row's cluster gets for (rows, k), candidates a
    # tile, widest row
    "nms_cluster_ctas": (_I, _I),
    "nms_tile_candidates": (),
    "nms_cluster_max_k": (),
    # the dynamic shared memory each tensor-core kernel asks for, in bytes
    "fused_vgg_block1_smem_bytes": (),
    "fused_vgg_block2_smem_bytes": (),
    "fused_stem_conv_relu_pool2_smem_bytes": (),
    "fused_conv3x3_relu_pool2_smem_bytes": (),
    # the block-2 kernel's weight ring (8 KB units) and, for an output width c, its conv B's N: the
    # slab width of conv B's weight image (conv A's is 64)
    "fused_vgg_block2_stages": (),
    "fused_vgg_block2_conv_b_n": (_I,),
}
# A library built with -DRON_KB2_TRACE also holds the block-2 kernel's clock64() split: host buffer
# of [blocks][4][slots] int64 <- the last launch's; the blocks and slots it keeps.
TRACE_SIGNATURES = {"fused_vgg_block2_trace": (_P,), "fused_vgg_block2_trace_blocks": (),
                    "fused_vgg_block2_trace_slots": ()}


def nvcc_path() -> str:
    candidate = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (looked in $CUDA_HOME/bin and on PATH)")
    return found


def _flags(defines=()) -> tuple:
    return NVCC_FLAGS + tuple(f"-D{d}" for d in defines)


def library_path(defines=()) -> Path:
    digest = hashlib.sha256(" ".join(_flags(defines)).encode())
    for name in SOURCES + HEADERS:
        digest.update((CSRC_DIR / name).read_bytes())
    return BUILD_DIR / f"libron_kernels_{digest.hexdigest()[:16]}.so"


def build_log_path(defines=()) -> Path:
    """nvcc's output (ptxas's per-kernel report) of the library's build."""
    return library_path(defines).with_suffix(".log")


def build(defines=()) -> Path:
    """Compile every source with one nvcc call (with `-D` of each of
    `defines`); returns the library path. Writes to a temporary name first,
    so concurrent processes never load a half-written file."""
    out = library_path(defines)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc_path(), *_flags(defines), "-o", tmp, *(str(CSRC_DIR / s) for s in SOURCES)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=BUILD_TIMEOUT_S)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{proc.stdout}\n{proc.stderr}"
            )
        build_log_path(defines).write_text(proc.stdout + proc.stderr)
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return out


@functools.lru_cache(maxsize=None)
def library(defines=()) -> ctypes.CDLL:
    """The loaded kernel library (built on first call). `defines` (a tuple
    of macro names) builds a variant beside it: ("RON_KB2_TRACE",) holds
    the block-2 kernel's clock64() split (`TRACE_SIGNATURES`)."""
    lib = ctypes.CDLL(str(build(defines)))
    signatures = {**SIGNATURES, **(TRACE_SIGNATURES if "RON_KB2_TRACE" in defines else {})}
    for name, argtypes in signatures.items():
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


def ptxas_report(defines=()) -> dict:
    """{kernel's mangled name: {"registers", "spill_stores", "spill_loads"}}
    from ptxas's report of the build (`-Xptxas -v`)."""
    report, name = {}, None
    for line in build_log_path(defines).read_text().splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) '?([\w$]+)'?", line)
        if m:
            name = m.group(1)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and name:
            report.setdefault(name, {}).update(spill_stores=int(m.group(1)), spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            report.setdefault(name, {})["registers"] = int(m.group(1))
    return report
