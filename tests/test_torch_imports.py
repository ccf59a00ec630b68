"""The port and chip_smoke.py import neither JAX, flax, optax, ml_dtypes,
orbax, TensorFlow, grain nor the JAX package: a GPU host running the port
need not have any of them (the card host has no grain: the port's
Grain-equivalent pipeline carries its own sampler). The orbax converter,
which needs JAX, lives outside the package."""

import pkgutil
import subprocess
import sys
from pathlib import Path

import ron_tensorflow_tpu_torch

REPO = Path(__file__).resolve().parent.parent
BLOCKED = ("jax", "jaxlib", "flax", "optax", "ml_dtypes", "orbax", "tensorflow", "grain", "ron_tensorflow_tpu")


def port_modules():
    return ["ron_tensorflow_tpu_torch"] + [
        m.name
        for m in pkgutil.walk_packages(ron_tensorflow_tpu_torch.__path__, "ron_tensorflow_tpu_torch.")
    ]


def test_port_modules_found():
    mods = port_modules()
    for name in ("kernels.nms", "kernels.fused_conv_pool", "kernels._build", "inference.detector", "weights",
                 "eval.evaluator", "eval.realtime", "ops.matching", "ops.nms", "ops.encode", "losses.ron",
                 "train.optimizer", "train.state", "train.checkpoint", "train.trainer", "config",
                 "data.pipeline", "utils.summaries", "utils.profiling", "models.ssd", "models.testing",
                 "losses.ssd", "data.example", "data.tfrecord", "data.native", "utils.tensorboard",
                 "train.tf_checkpoint", "train.caffe_import", "cli", "data.jpeg", "data.decode", "data.convert",
                 "data.voc", "presets", "parallel", "parallel.mesh", "parallel.multihost", "parallel.collectives",
                 "parallel.testing", "data.grain_pipeline", "models.zoo", "models.zoo_import", "data.classification",
                 "data.factory", "tools.overfit_check", "tools.synthetic_e2e", "tools.synthetic_data",
                 "tools.train_supervised", "utils.debug_nans", "bench"):
        assert f"ron_tensorflow_tpu_torch.{name}" in mods
    from ron_tensorflow_tpu_torch.inference.detector import RealtimeDetector  # noqa: F401
    from ron_tensorflow_tpu_torch.train.trainer import Trainer  # noqa: F401
    from ron_tensorflow_tpu_torch.models.ssd import SSD  # noqa: F401


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


def test_orbax_converter_lives_outside_the_package():
    converter = REPO / "tools" / "orbax_to_npz.py"
    assert converter.is_file()
    package = Path(ron_tensorflow_tpu_torch.__file__).resolve().parent
    assert package not in converter.resolve().parents
    assert not any(m.endswith("orbax_to_npz") for m in port_modules())
    assert "orbax" in converter.read_text()


LEARNING_TOOLS = ["ron_tensorflow_tpu_torch.tools.overfit_check", "ron_tensorflow_tpu_torch.tools.synthetic_e2e",
                  "ron_tensorflow_tpu_torch.tools.synthetic_data", "ron_tensorflow_tpu_torch.utils.debug_nans"]


def test_learning_tools_import_without_pil():
    """The learning checks draw and encode their images themselves: they
    need no PIL (nor JAX). The supervisor needs only the standard library."""
    blocked = BLOCKED + ("PIL",)
    code = "\n".join(
        [
            "import importlib, subprocess, sys",
            f"for name in {blocked!r}:",
            "    sys.modules[name] = None",
            f"for name in {LEARNING_TOOLS!r}:",
            "    importlib.import_module(name)",
            f"leaked = [m for m in sys.modules if m.split('.')[0] in {blocked!r} and sys.modules[m] is not None]",
            "assert not leaked, leaked",
            "print('ok')",
        ]
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("ok")
    script = REPO / "ron_tensorflow_tpu_torch" / "tools" / "train_supervised.py"
    stdlib_only = ("import runpy, sys\n"
                   "for name in ('torch', 'numpy', 'ron_tensorflow_tpu_torch') + " + repr(blocked) + ":\n"
                   "    sys.modules[name] = None\n"
                   f"sys.argv = [{str(script)!r}, '--help']\n"
                   f"runpy.run_path({str(script)!r}, run_name='__main__')\n")
    proc = subprocess.run([sys.executable, "-c", stdlib_only], cwd=REPO, capture_output=True, text=True, timeout=60)
    assert proc.returncode == 0 and "--probe-timeout" in proc.stdout, proc.stderr


# The modules that decode, draw and write pictures, and those that call them.
PICTURE_MODULES = ["ron_tensorflow_tpu_torch.data.decode", "ron_tensorflow_tpu_torch.data.png",
                   "ron_tensorflow_tpu_torch.data.jpeg", "ron_tensorflow_tpu_torch.data.pipeline",
                   "ron_tensorflow_tpu_torch.utils.visualization", "ron_tensorflow_tpu_torch.utils.tensorboard",
                   "ron_tensorflow_tpu_torch.train.trainer", "ron_tensorflow_tpu_torch.eval.realtime",
                   "ron_tensorflow_tpu_torch.cli", "ron_tensorflow_tpu_torch.kernels.nms",
                   "ron_tensorflow_tpu_torch.inference.detector"]


def test_picture_modules_import_without_pil_or_cv2():
    """The modules that read, draw and write images need neither PIL nor
    cv2 (nor JAX): none of them is imported, by them or by what they import."""
    blocked = BLOCKED + ("PIL", "cv2")
    code = "\n".join(
        [
            "import importlib, sys",
            f"for name in {blocked!r}:",
            "    sys.modules[name] = None",
            f"for name in {PICTURE_MODULES + ['chip_smoke']!r}:",
            "    importlib.import_module(name)",
            f"leaked = [m for m in sys.modules if m.split('.')[0] in {blocked!r} and sys.modules[m] is not None]",
            "assert not leaked, leaked",
            "print('ok')",
        ]
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("ok")


REHEARSAL_TOOLS = ["ron_tensorflow_tpu_torch.tools.dress_rehearsal",
                   "ron_tensorflow_tpu_torch.tools.ab_detection_config",
                   "ron_tensorflow_tpu_torch.tools.synthetic_data"]


def test_rehearsal_tools_import_without_jax_pil_or_cv2():
    """The dress rehearsal and its A/B draw, encode, train and score with the
    port alone: neither JAX, the JAX package, PIL nor cv2 is imported."""
    blocked = BLOCKED + ("PIL", "cv2")
    mods = port_modules()
    assert all(name in mods for name in REHEARSAL_TOOLS)
    code = "\n".join(
        [
            "import importlib, sys",
            f"for name in {blocked!r}:",
            "    sys.modules[name] = None",
            f"for name in {REHEARSAL_TOOLS!r}:",
            "    importlib.import_module(name)",
            f"leaked = [m for m in sys.modules if m.split('.')[0] in {blocked!r} and sys.modules[m] is not None]",
            "assert not leaked, leaked",
            "print('ok')",
        ]
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("ok")


PROBE_TOOLS = ["ron_tensorflow_tpu_torch.tools." + name for name in (
    "perf_common", "list_caffemodel", "perf_breakdown", "perf_post", "perf_topk", "perf_block_times",
    "perf_remat12_bandwidth", "perf_train_breakdown", "perf_step_probe", "perf_train_experiments", "leak_probe")]


def test_probe_tools_import_without_jax():
    """The ported repo-root tools (the perf probes, the leak probe, the
    Caffe lister) are in the package and import neither JAX, flax,
    ml_dtypes nor the JAX package (nor anything else BLOCKED)."""
    mods = port_modules()
    assert all(name in mods for name in PROBE_TOOLS)
    code = "\n".join(
        [
            "import importlib, sys",
            f"for name in {BLOCKED!r}:",
            "    sys.modules[name] = None",
            f"for name in {PROBE_TOOLS!r}:",
            "    importlib.import_module(name)",
            f"leaked = [m for m in sys.modules if m.split('.')[0] in {BLOCKED!r} and sys.modules[m] is not None]",
            "assert not leaked, leaked",
            "print('ok')",
        ]
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("ok")
