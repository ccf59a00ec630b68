"""Every public name of the JAX package has a counterpart in the port.

The test walks `ron_tensorflow_tpu`'s modules (`pkgutil.walk_packages`).
For each module, the public names it defines (top-level functions, classes
and assignments whose names do not start with `_`; names it imports are
the defining module's) must exist in the port's module of the same path
(`ron_tensorflow_tpu_torch.<same path>`), and each field of a JAX
dataclass or NamedTuple (flax modules are dataclasses) must be a field of
the port's counterpart, or a parameter of its `__init__` or `forward`.
What has no counterpart stands on the lists below, each with its reason;
the lists must hold nothing that has one. When the lists hold only
PyTorch idiom and the deliberate omissions, the port does all that the
JAX package does.
"""

import ast
import dataclasses
import importlib
import inspect
import pkgutil
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ron_tensorflow_tpu
from ron_tensorflow_tpu.data.pipeline import PipelineConfig as JaxPipelineConfig
from ron_tensorflow_tpu.ops import select as jax_select
from ron_tensorflow_tpu.ops.math import cummax as jax_cummax

from ron_tensorflow_tpu_torch.data import decode, grain_pipeline, pipeline
from ron_tensorflow_tpu_torch.data.pipeline import PipelineConfig
from ron_tensorflow_tpu_torch.inference.detector import DetectionConfig
from ron_tensorflow_tpu_torch.models import layers
from ron_tensorflow_tpu_torch.models.ron import RON
from ron_tensorflow_tpu_torch.models.ssd import SSD
from ron_tensorflow_tpu_torch.models.vgg import VGG16Backbone
from ron_tensorflow_tpu_torch.ops import select
from ron_tensorflow_tpu_torch.ops.math import cummax

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_grain import _write_shard  # noqa: E402

# flax module fields that PyTorch spells otherwise: `dtype` (the port's
# modules take it at the top, where it casts the input), `train` (an
# argument of `forward`), `parent` and `name` (the module tree itself).
FLAX_FIELDS = {"dtype", "train", "parent", "name"}

# JAX modules the port names otherwise: path -> (port path, {JAX name: port name}).
RENAMED_MODULES = {
    "kernels.nms_pallas": ("kernels.nms", {
        "pallas_nms_keep_mask": "nms_scan_keep_mask",  # K-C
        "pallas_nms_fixpoint_keep_mask": "nms_fixpoint_keep_mask",  # K-A
        "nms_sorted_pallas": "nms_sorted_kernel",
    }),
}

# (module, name) -> why the port has no counterpart.
NAME_EXCEPTIONS = {
    ("kernels.nms_pallas", "ROW_TILE"): "TPU tiling: rows of the scan kernel per grid program (a sublane tile)",
    ("kernels.nms_pallas", "GROUP"): "TPU tiling: NMS instances per grid program of the fixpoint kernel",
    ("kernels.fused_conv_pool", "merge_stem_weights"):
        "TPU layout: K-D's column-pair merged taps for the MXU; the CUDA kernel reads OIHW taps",
    ("parallel.mesh", "replicated"): "JAX sharding: a NamedSharding tree; torch.distributed replicates by broadcast",
    ("models.layers", "Dtype"): "a typing alias of flax modules' dtype fields",
}

# (module, class, field) -> why the port's counterpart has no field of that name.
FIELD_EXCEPTIONS = {
    ("models.layers", "BatchNorm", "axis_name"):
        "a named mesh axis; the port's BatchNorm takes its mesh's `data_group` (set by `shard_model`)",
    ("models.layers", "BatchNorm", "epsilon"): "torch's name: `eps`",
    ("models.layers", "BatchNorm", "use_running_average"): "the forward's `train` (its negation)",
    ("models.layers", "Conv", "act"): "a callable or None in flax; the port's Conv takes `relu: bool`",
    ("models.layers", "ConvTranspose", "act"):
        "the port's ConvTranspose is the reverse connection's deconv, ReLU always (as every JAX call site)",
    ("models.layers", "ConvTranspose", "kernel"): "fixed 2x2, as every JAX call site",
    ("models.layers", "ConvTranspose", "strides"): "fixed 2x2, as every JAX call site",
    ("models.ssd", "SSDExtraBlock", "kernel"):
        "3x3 at every JAX call site; SSD-512's 4x4 block12 is `block12_conv1x1` + `block12_conv4x4` on SSD",
}

# What the port leaves out on purpose, though the name exists (ROADMAP.md):
# nothing. PNG input, progressive JPEG, pictures drawn and written without
# PIL and NMS rows of any width on the card were its last omissions.
DELIBERATE_OMISSIONS = ()


def jax_modules():
    return [m.name[len("ron_tensorflow_tpu."):]
            for m in pkgutil.walk_packages(ron_tensorflow_tpu.__path__, "ron_tensorflow_tpu.")]


def defined_names(module):
    """Public top-level functions, classes and assigned names of the module's source."""
    names = []
    for node in ast.parse(inspect.getsource(module)).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            names.append(node.name)
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) else [node.target]
            names += [t.id for t in targets if isinstance(t, ast.Name)]
    return [n for n in dict.fromkeys(names) if not n.startswith("_")]


def record_fields(cls):
    if dataclasses.is_dataclass(cls):
        return {f.name for f in dataclasses.fields(cls)}
    return set(getattr(cls, "_fields", ()))


def counterpart_fields(obj):
    fields = record_fields(obj)
    if inspect.isclass(obj):
        for fn in ("__init__", "forward"):
            f = getattr(obj, fn, None)
            if f is not None and f is not object.__init__:
                fields |= set(inspect.signature(f).parameters)
    return fields


def port_counterpart(path):
    port_path, renames = RENAMED_MODULES.get(path, (path, {}))
    return importlib.import_module(f"ron_tensorflow_tpu_torch.{port_path}"), renames


def gaps():
    """(missing names, missing fields) against the exception lists."""
    names, fields = [], []
    for path in jax_modules():
        module = importlib.import_module(f"ron_tensorflow_tpu.{path}")
        port, renames = port_counterpart(path)
        for name in defined_names(module):
            if (path, name) in NAME_EXCEPTIONS:
                continue
            target = getattr(port, renames.get(name, name), None)
            if target is None:
                names.append((path, name))
                continue
            jax_obj = getattr(module, name)
            if not inspect.isclass(jax_obj):
                continue
            for field in sorted(record_fields(jax_obj) - FLAX_FIELDS - counterpart_fields(target)):
                if (path, name, field) not in FIELD_EXCEPTIONS:
                    fields.append((path, name, field))
    return names, fields


def test_every_jax_module_has_a_port_module():
    missing = []
    for path in jax_modules():
        try:
            port_counterpart(path)
        except ImportError:
            missing.append(path)
    assert not missing


def test_every_public_name_and_field_has_a_counterpart():
    names, fields = gaps()
    assert not names, f"JAX names without a counterpart in the port (or an entry in NAME_EXCEPTIONS): {names}"
    assert not fields, f"JAX fields without a counterpart in the port (or an entry in FIELD_EXCEPTIONS): {fields}"


@pytest.mark.parametrize("kind", ["names", "fields", "renames"])
def test_exceptions_hold_only_what_has_no_counterpart(kind):
    """An entry whose name the port now has, or that the JAX package no
    longer defines, is stale: the lists say only what is true."""
    stale = []
    if kind == "names":
        for path, name in NAME_EXCEPTIONS:
            module = importlib.import_module(f"ron_tensorflow_tpu.{path}")
            port, renames = port_counterpart(path)
            if name not in defined_names(module) or hasattr(port, renames.get(name, name)):
                stale.append((path, name))
    elif kind == "fields":
        for path, name, field in FIELD_EXCEPTIONS:
            jax_obj = getattr(importlib.import_module(f"ron_tensorflow_tpu.{path}"), name)
            port, _ = port_counterpart(path)
            if field not in record_fields(jax_obj) or field in counterpart_fields(getattr(port, name)):
                stale.append((path, name, field))
    else:
        for path, (port_path, renames) in RENAMED_MODULES.items():
            assert path in jax_modules()
            with pytest.raises(ImportError):
                importlib.import_module(f"ron_tensorflow_tpu_torch.{path}")
            port = importlib.import_module(f"ron_tensorflow_tpu_torch.{port_path}")
            stale += [(path, n) for n, p in renames.items() if not hasattr(port, p)]
    assert not stale


def test_ported_fields_and_names_of_this_slice():
    """The names this file's walk found missing before the last gaps were
    ported, each now on the port's module of the same path."""
    assert {"prefetch", "grain_workers"} <= record_fields(PipelineConfig)
    assert {"nms_method", "split_apply"} <= record_fields(DetectionConfig)
    assert {"s2d_stem", "remat_blocks12"} <= counterpart_fields(RON) & counterpart_fields(VGG16Backbone)
    assert "s2d_stem" in counterpart_fields(SSD)
    assert DELIBERATE_OMISSIONS == ()


# --------------------------------------------------------------------------- #
# The counterparts that the walk asked for, against JAX's on seeded inputs.


@pytest.mark.parametrize("axis", [0, 1])
@pytest.mark.parametrize("reverse", [False, True])
def test_cummax_matches_jax(axis, reverse):
    x = np.random.default_rng(0).normal(size=(5, 7)).astype(np.float32)
    np.testing.assert_array_equal(cummax(torch.as_tensor(x), reverse, axis).numpy(),
                                  np.asarray(jax_cummax(jnp.asarray(x), reverse, axis)))


@pytest.mark.parametrize("threshold", [None, 0.0, 0.3])
def test_select_functions_match_jax(threshold):
    """select_per_class, select_all_classes and the objectness gate on
    seeded [2, N, C] probabilities (ties included: a row of equal
    scores), bit for bit."""
    rng = np.random.default_rng(1)
    pred = rng.dirichlet(np.ones(6), size=(2, 40)).astype(np.float32)
    pred[0, 3] = 1.0 / 6
    locs = rng.uniform(size=(2, 40, 4)).astype(np.float32)
    objness = rng.uniform(size=(40,)).astype(np.float32)
    got = select.select_per_class(torch.as_tensor(pred), torch.as_tensor(locs), threshold or 0.0)
    ref = jax_select.select_per_class(jnp.asarray(pred), jnp.asarray(locs), threshold or 0.0)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    got = select.select_all_classes(torch.as_tensor(pred), torch.as_tensor(locs), threshold)
    ref = jax_select.select_all_classes(jnp.asarray(pred), jnp.asarray(locs), threshold)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    gate = 0.5 if threshold is None else threshold
    got = select.objectness_gated_predictions(torch.as_tensor(pred[0]), torch.as_tensor(objness), gate)
    ref = jax_select.objectness_gated_predictions(jnp.asarray(pred[0]), jnp.asarray(objness), gate)
    assert got._fields == ref._fields
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


def test_set_bn_fast_normalize_is_the_modules_switch_for_all():
    """`set_bn_fast_normalize(True)` makes every BatchNorm normalize a bf16
    activation as `fast_normalize=True` does; off again, as before."""
    x = torch.randn(4, 3, 5, 5, generator=torch.Generator().manual_seed(2)).to(torch.bfloat16)
    fast, plain = layers.BatchNorm(3), layers.BatchNorm(3)
    fast.fast_normalize = True
    want_fast, want_plain = fast(x, train=True), plain(x, train=True)
    assert not torch.equal(want_fast, want_plain)
    try:
        layers.set_bn_fast_normalize(True)
        assert torch.equal(layers.BatchNorm(3)(x, train=True), want_fast)
    finally:
        layers.set_bn_fast_normalize(False)
    assert torch.equal(layers.BatchNorm(3)(x, train=True), want_plain)


def test_pipeline_names_and_grain_workers(tmp_path):
    """`decode_jpeg_raw` is the port's decoder; `grain_batch_iterator` gives
    `GrainBatches`' batches; `grain_workers` decode threads and `prefetch`
    change no batch; JAX's call sites construct `PipelineConfig`."""
    assert pipeline.decode_jpeg_raw is decode.decode_jpeg_raw
    kw = dict(batch_size=2, working_shape=(32, 32), max_boxes=4, shuffle=True, seed=3)
    assert {f.name for f in dataclasses.fields(JaxPipelineConfig)} <= record_fields(pipeline.PipelineConfig)
    shard = [_write_shard(tmp_path, n=6)]
    base = list(grain_pipeline.GrainBatches(shard, pipeline.PipelineConfig(**kw, decode_workers=1), epochs=1))
    for cfg in (dict(grain_workers=3, prefetch=1), dict(decode_workers=1)):
        got = list(grain_pipeline.grain_batch_iterator(shard, pipeline.PipelineConfig(**kw, **cfg), epochs=1))
        assert len(got) == len(base) == 3
        for g, b in zip(got, base):
            assert g.keys() == b.keys()
            for k in b:
                np.testing.assert_array_equal(g[k], b[k])
