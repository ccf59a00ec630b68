"""The port and chip_smoke.py import neither JAX, flax, ml_dtypes nor the
JAX package: a GPU host running the port need not have any of them."""

import pkgutil
import subprocess
import sys
from pathlib import Path

import ron_tensorflow_tpu_torch

REPO = Path(__file__).resolve().parent.parent
BLOCKED = ("jax", "jaxlib", "flax", "ml_dtypes", "ron_tensorflow_tpu")


def port_modules():
    return ["ron_tensorflow_tpu_torch"] + [
        m.name
        for m in pkgutil.walk_packages(ron_tensorflow_tpu_torch.__path__, "ron_tensorflow_tpu_torch.")
    ]


def test_port_modules_found():
    mods = port_modules()
    for name in ("kernels.nms", "kernels.fused_conv_pool", "kernels._build", "inference.detector", "weights"):
        assert f"ron_tensorflow_tpu_torch.{name}" in mods


def test_port_and_chip_smoke_import_without_jax():
    code = "\n".join(
        [
            "import importlib, sys",
            f"for name in {BLOCKED!r}:",
            "    sys.modules[name] = None  # any import of it raises ImportError",
            f"for name in {port_modules() + ['chip_smoke']!r}:",
            "    importlib.import_module(name)",
            f"leaked = [m for m in sys.modules if m.split('.')[0] in {BLOCKED!r} and sys.modules[m] is not None]",
            "assert not leaked, leaked",
            "print('ok')",
        ]
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=300
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("ok")
