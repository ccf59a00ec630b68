"""The port's realtime head (RealtimeDetector, both modes) and the NMS ops
under it against the JAX package, on the CPU, with the same numpy-made
inputs and weights on both sides.

Tolerances: labels, valid flags and keep sets must be equal. Detection
scores and boxes of the head within 1e-5 (both sides decode in float32 on
the CPU and differ by a few ulps); `nms_with_labels` on the same candidates
bit for bit. K-C's plain version equals the Pallas scan kernel in interpret
mode bit for bit. The slow RON-320 test uses the fixtures' own gate of
tests/test_e2e_parity.py (equal counts and labels, 2e-3).
"""

import dataclasses
import json
import os
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ron_tensorflow_tpu.inference.detector import RealtimeConfig as JaxRealtimeConfig
from ron_tensorflow_tpu.inference.detector import RealtimeDetector as JaxRealtimeDetector
from ron_tensorflow_tpu.kernels.nms_pallas import pallas_nms_keep_mask
from ron_tensorflow_tpu.models.ron import RON as JaxRON
from ron_tensorflow_tpu.models.ron import DetectorOutputs as JaxDetectorOutputs
from ron_tensorflow_tpu.models.testing import RON_TINY_SPEC as JAX_TINY_SPEC
from ron_tensorflow_tpu.ops import nms as jax_nms
from ron_tensorflow_tpu.train.checkpoint import flatten_params, unflatten_params

from ron_tensorflow_tpu_torch import kernels
from ron_tensorflow_tpu_torch.data.preprocess import whiten
from ron_tensorflow_tpu_torch.data.resize import tf1_bilinear_resize
from ron_tensorflow_tpu_torch.inference.detector import RealtimeConfig, RealtimeDetector
from ron_tensorflow_tpu_torch.kernels.nms import compact_keep, compact_keep_labelled
from ron_tensorflow_tpu_torch.models.ron import RON, DetectorOutputs
from ron_tensorflow_tpu_torch.models.spec import RON_320_SPEC, RON_TINY_SPEC
from ron_tensorflow_tpu_torch.ops import nms as port_nms
from ron_tensorflow_tpu_torch.weights import from_jax_params, load_trained_fixture

E2E_FIXTURE = "tests/fixtures/e2e_parity.npz"
TRAINED_FIXTURE = "tests/fixtures/e2e_parity_trained.npz"
FWD_FIXTURE = "tests/fixtures/reference_forward.npz"
IMAGES = ("1", "2", "3", "4")


# --------------------------------------------------------------------------- #
# shared: tiny RON with the same numpy-made weights on both sides


def make_tiny(seed=4):
    """JAX tiny RON with numpy-seeded weights and BN statistics, and the
    port's model loaded from the same numbers: (jax model, its variables,
    port model)."""
    rng = np.random.default_rng(seed)
    jmodel = JaxRON(spec=JAX_TINY_SPEC)
    shapes = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(seed), jnp.zeros((1, 64, 64, 3)), train=False))
    params = {}
    for k, v in flatten_params(shapes["params"]).items():
        if k.endswith("kernel"):  # HWIO: fan-in scaled, so activations stay O(1)
            v = rng.normal(0.0, 1.0, v.shape) / np.sqrt(np.prod(v.shape[:-1]))
        elif k.endswith("scale"):
            v = rng.uniform(0.5, 1.5, v.shape)
        else:
            v = rng.normal(0.0, 0.1, v.shape)
        params[k] = v.astype(np.float32)
    stats = {}
    for k, v in flatten_params(shapes["batch_stats"]).items():
        v = rng.normal(0.0, 0.1, v.shape) if k.endswith("mean") else rng.uniform(0.5, 1.5, v.shape)
        stats[k] = v.astype(np.float32)
    jvars = {
        "params": jax.tree.map(jnp.asarray, unflatten_params(params)),
        "batch_stats": jax.tree.map(jnp.asarray, unflatten_params(stats)),
    }
    model = RON(RON_TINY_SPEC)
    model.load_state_dict(from_jax_params(params, stats), strict=True)
    return jmodel, jvars, model


@pytest.fixture(scope="module")
def tiny():
    return make_tiny()


def whitened(pixels, shape=(64, 64)):
    return np.stack([whiten(torch.as_tensor(tf1_bilinear_resize(p, shape) / 255.0)).numpy() for p in pixels])


# --------------------------------------------------------------------------- #
# nms_with_labels against JAX


def labelled_rows(seed, r, n, grid=None, ties=True, zero_valid=False):
    """Rows of whole-image candidates: scores with many ties (quantized to
    1/16), labels, boxes (snapped to a 1/grid grid, so overlaps land on
    thresholds exactly) and valid flags. zero_valid: some valid candidates
    score 0 (a negative select threshold lets that happen)."""
    rng = np.random.default_rng(seed)
    scores = rng.uniform(0.0, 1.0, (r, n)).astype(np.float32)
    if ties:
        scores = np.round(scores * 16) / 16
    cy, cx = rng.uniform(0.2, 0.8, (2, r, n))
    h, w = rng.uniform(0.05, 0.4, (2, r, n))
    boxes = np.stack([cy - h / 2, cx - w / 2, cy + h / 2, cx + w / 2], -1)
    if grid:
        boxes = np.round(boxes * grid) / grid
    labels = rng.integers(1, 21, (r, n)).astype(np.int32)
    valid = rng.uniform(size=(r, n)) < 0.6
    if zero_valid:
        scores[rng.uniform(size=(r, n)) < 0.3] = 0.0
    return scores.astype(np.float32), labels, boxes.astype(np.float32), valid


def jax_nms_with_labels(scores, labels, boxes, valid, thr, top_k, keep_top_k, mode):
    fn = lambda s, l, b, v: jax_nms.nms_with_labels(s, l, b, v, thr, top_k, keep_top_k, mode)  # noqa: E731
    return [np.asarray(a) for a in jax.vmap(fn)(*(jnp.asarray(a) for a in (scores, labels, boxes, valid)))]


NMS_LABEL_CASES = [
    # (seed, rows, N, grid, threshold, top_k, keep_top_k, mode, zero_valid)
    (0, 3, 600, None, 0.4, 400, 20, "union", False),  # the realtime head's defaults
    (1, 2, 300, 8, 0.5, 400, 20, "union", False),  # top_k > N; exact-threshold overlaps
    (2, 4, 500, 4, 0.25, 64, 40, "min", False),  # 'min' mode, a cap that binds
    (3, 2, 300, 8, 0.5, 128, 200, "union", True),  # valid candidates of score 0
    (4, 1, 2100, None, 0.3, 2048, 40, "union", False),  # top_k 2048 (one stable sort)
]


@pytest.mark.parametrize("seed,r,n,grid,thr,top_k,keep_top_k,mode,zero_valid", NMS_LABEL_CASES)
def test_nms_with_labels_matches_jax(seed, r, n, grid, thr, top_k, keep_top_k, mode, zero_valid):
    scores, labels, boxes, valid = labelled_rows(seed, r, n, grid, zero_valid=zero_valid)
    ref = jax_nms_with_labels(scores, labels, boxes, valid, thr, top_k, keep_top_k, mode)
    kernels.reset_launch_counts()
    got = port_nms.nms_with_labels(*(torch.as_tensor(a) for a in (scores, labels, boxes, valid)),
                                   thr, top_k, keep_top_k, mode)
    assert kernels.nms_scan_keep_mask.launches == 0  # CPU tensors: the plain version
    assert [g.dtype for g in got] == [torch.float32, torch.int32, torch.float32, torch.bool]
    for name, g, r_ in zip(("scores", "labels", "boxes", "valid"), got, ref):
        assert g.shape == r_.shape, name
        np.testing.assert_array_equal(g.numpy(), r_, err_msg=name)
    assert ref[3].any()
    # padding past the kept ones is zero, labels and valid included
    n_kept = ref[3].sum(-1)
    for row in range(r):
        assert not got[1][row, n_kept[row]:].any() and not got[3][row, n_kept[row]:].any()


def test_nms_with_labels_takes_valid_zero_scores():
    """A valid candidate of score 0 is taken (JAX takes on valid), which
    K-C's own `score > 0` would not do: the head gives K-C the valid flags."""
    scores = np.array([[0.5, 0.0, 0.0, 0.2]], np.float32)
    boxes = np.array([[[0.0, 0.0, 0.2, 0.2], [0.5, 0.5, 0.7, 0.7], [0.5, 0.5, 0.7, 0.7], [0.8, 0.8, 0.9, 0.9]]],
                     np.float32)
    labels = np.array([[1, 2, 3, 4]], np.int32)
    valid = np.array([[True, True, False, True]])
    got = port_nms.nms_with_labels(*(torch.as_tensor(a) for a in (scores, labels, boxes, valid)), 0.4, 4, 4)
    ref = jax_nms_with_labels(scores, labels, boxes, valid, 0.4, 4, 4, "union")
    for g, r_ in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), r_)
    assert got[3].tolist() == [[True, True, True, False]]
    assert got[1].tolist() == [[1, 4, 2, 0]]


def test_compact_keep_labelled_matches_compact_keep():
    scores, labels, boxes, _ = labelled_rows(5, 3, 40, ties=False)
    keep = torch.as_tensor(np.random.default_rng(5).uniform(size=(3, 40)) < 0.5)
    s, l, b, v = compact_keep_labelled(keep, torch.as_tensor(scores), torch.as_tensor(labels),
                                       torch.as_tensor(boxes), 8)
    ref_s, ref_b = compact_keep(keep, torch.as_tensor(scores), torch.as_tensor(boxes), 8)
    assert torch.equal(s, ref_s) and torch.equal(b, ref_b)
    assert torch.equal(v, torch.arange(8)[None] < keep.sum(-1, keepdim=True).clamp(max=8))
    assert torch.equal(l != 0, v)


@pytest.mark.parametrize("n,top_k", [(50, 16), (300, 400), (21250, 400)])
def test_sort_by_score_matches_jax(n, top_k):
    rng = np.random.default_rng(n)
    scores = np.round(rng.uniform(size=(2, n)) * 8).astype(np.float32) / 8  # many ties
    boxes = rng.uniform(size=(2, n, 4)).astype(np.float32)
    ref_s, ref_b = jax.vmap(lambda s, b: jax_nms.sort_by_score(s, b, top_k))(jnp.asarray(scores), jnp.asarray(boxes))
    got_s, got_b = port_nms.sort_by_score(torch.as_tensor(scores), torch.as_tensor(boxes), top_k)
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(ref_s))
    np.testing.assert_array_equal(got_b.numpy(), np.asarray(ref_b))


@pytest.mark.parametrize("mode", ["union", "min"])
def test_overlap_matrix_matches_jax(mode):
    _, _, boxes, _ = labelled_rows(6, 1, 64, grid=8)
    boxes[0, 3] = boxes[0, 3, [0, 1, 0, 1]]  # an empty box: denominator 0 in 'min' mode
    ref = jax_nms.overlap_matrix(jnp.asarray(boxes[0]), mode)
    got = port_nms.overlap_matrix(torch.as_tensor(boxes[0]), mode)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    with pytest.raises(ValueError):
        port_nms.overlap_matrix(torch.as_tensor(boxes[0]), "max")


@pytest.mark.parametrize("mode", ["min", "union"])
def test_nms_per_class_matches_jax(mode):
    scores, _, boxes, _ = labelled_rows(7, 5, 100, grid=8)
    order = np.argsort(-scores, axis=-1, kind="stable")
    scores = np.take_along_axis(scores, order, -1)
    boxes = np.take_along_axis(boxes, order[..., None], -2)
    ref_s, ref_b = jax_nms.nms_per_class(jnp.asarray(scores), jnp.asarray(boxes), 0.5, 30, mode)
    got_s, got_b = port_nms.nms_per_class(torch.as_tensor(scores), torch.as_tensor(boxes), 0.5, 30, mode)
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(ref_s))
    np.testing.assert_array_equal(got_b.numpy(), np.asarray(ref_b))


# --------------------------------------------------------------------------- #
# K-C on the realtime head's rows, against the Pallas scan kernel


@pytest.mark.parametrize("rows", [1, 32])
@pytest.mark.parametrize("flags", [False, True])
def test_scan_plain_matches_pallas_on_realtime_rows(rows, flags):
    """K-C's CPU path at the realtime head's rows: [B, 400], union, cap 20.
    flags: the rows the head gives K-C (1.0 / 0.0 valid flags as scores,
    ties everywhere); else score-sorted random scores."""
    scores, _, boxes, valid = labelled_rows(rows, rows, 400, grid=8 if flags else None, ties=False)
    if flags:
        scores = np.sort(valid.astype(np.float32), axis=-1)[:, ::-1].copy()
    else:
        scores = np.sort(scores, axis=-1)[:, ::-1].copy()
    ref = np.asarray(pallas_nms_keep_mask(jnp.asarray(scores), jnp.asarray(boxes), 0.4, 20, "union",
                                          interpret=True))
    got = kernels.nms_scan_keep_mask(torch.as_tensor(scores), torch.as_tensor(boxes), 0.4, 20, "union")
    np.testing.assert_array_equal(got.numpy(), ref)
    assert int(got.sum(-1).max()) <= 20 and got.any()


# --------------------------------------------------------------------------- #
# RealtimeDetector.postprocess against JAX


def random_outputs(seed, b, n, nan_objectness=False):
    """Head outputs (port, JAX) made with numpy: sharp class probabilities
    (some anchors tied on their top two classes, some copies of another
    anchor, so scores tie across anchors), objectness near 1 on a third of
    the anchors, and box offsets."""
    rng = np.random.default_rng(seed)
    c = RON_TINY_SPEC.num_classes
    logits = rng.normal(0.0, 3.0, (b, n, c)).astype(np.float32)
    top2 = np.argsort(-logits, -1)[..., :2]
    tie = rng.uniform(size=(b, n)) < 0.05
    np.put_along_axis(logits, top2[..., 1:], np.where(tie[..., None], np.take_along_axis(logits, top2[..., :1], -1),
                                                       np.take_along_axis(logits, top2[..., 1:], -1)), -1)
    preds = np.exp(logits - logits.max(-1, keepdims=True))
    preds = (preds / preds.sum(-1, keepdims=True)).astype(np.float32)
    objness = np.where(rng.uniform(size=(b, n)) < 0.35, rng.uniform(0.9, 1.0, (b, n)),
                       rng.uniform(0.0, 1.0, (b, n))).astype(np.float32)
    locations = rng.normal(0.0, 0.7, (b, n, 4)).astype(np.float32)
    dup = rng.integers(0, n, 20)
    preds[:, dup[10:]], objness[:, dup[10:]] = preds[:, dup[:10]], objness[:, dup[:10]]
    if nan_objectness:
        objness[:, rng.integers(0, n, 30)] = np.nan
    obj_logits = np.zeros((b, n, 2), np.float32)
    arrays = (preds, logits, objness, obj_logits, locations)
    return DetectorOutputs(*(torch.as_tensor(a) for a in arrays)), JaxDetectorOutputs(*(jnp.asarray(a) for a in arrays))


HEAD_CASES = {
    "published": dict(top_k=400),
    "dense": dict(select_threshold=0.2, objectness_threshold=0.3, nms_threshold=0.3, keep_top_k=40, top_k=128),
    "negative select": dict(select_threshold=-0.1, objectness_threshold=0.5, keep_top_k=30, top_k=256),
    "class-wise": dict(class_wise=True, select_threshold=0.05, objectness_threshold=0.3, top_k=64,
                       keep_per_class=10, keep_top_k=30, nms_mode="min"),
    "class-wise, union, negative select": dict(class_wise=True, select_threshold=-0.1, objectness_threshold=0.5,
                                               top_k=32, keep_per_class=8, keep_top_k=50),
    "class-wise, top_k > N": dict(class_wise=True, select_threshold=0.01, objectness_threshold=0.0,
                                  top_k=1000, keep_per_class=100, keep_top_k=200, nms_mode="min"),
}


def assert_head_equal(got, ref, atol=1e-5):
    got = [t.numpy() for t in got]
    ref = [np.asarray(a) for a in ref]
    assert got[1].dtype == np.int32 and got[3].dtype == np.bool_
    for name, g, r in zip(("scores", "labels", "boxes", "valid"), got, ref):
        assert g.shape == r.shape, name
    np.testing.assert_array_equal(got[3], ref[3], err_msg="valid")
    np.testing.assert_array_equal(got[1], ref[1], err_msg="labels")
    np.testing.assert_allclose(got[0], ref[0], rtol=0, atol=atol, err_msg="scores")
    np.testing.assert_allclose(got[2], ref[2], rtol=0, atol=atol, err_msg="boxes")
    return int(ref[3].sum())


@pytest.mark.parametrize("nan_objectness", [False, True])
@pytest.mark.parametrize("case", list(HEAD_CASES))
def test_realtime_postprocess_matches_jax(tiny, case, nan_objectness):
    """Both modes, with a per-image min_size vector, a negative select
    threshold and NaN objectness entries."""
    n = JAX_TINY_SPEC.anchor_layout().num_anchors
    out, jout = random_outputs(len(case), 3, n, nan_objectness)
    kwargs = HEAD_CASES[case]
    min_size = np.array([0.03, 0.15, 1e-6], np.float32)  # the last one is floored at 1e-4
    jdet = JaxRealtimeDetector(None, JAX_TINY_SPEC, JaxRealtimeConfig(**kwargs))
    ref = jdet.postprocess(jout, min_size=jnp.asarray(min_size))
    det = RealtimeDetector(tiny[2], RON_TINY_SPEC, RealtimeConfig(**kwargs), device="cpu")
    kernels.reset_launch_counts()
    with torch.inference_mode():
        got = det.postprocess(out, min_size=min_size)
    assert sum(kernels.launch_counts().values()) == 0
    assert assert_head_equal(got, ref) > 0


def test_realtime_postprocess_scalar_min_size_matches_jax(tiny):
    n = JAX_TINY_SPEC.anchor_layout().num_anchors
    out, jout = random_outputs(11, 2, n)
    cfg = dict(select_threshold=0.2, objectness_threshold=0.3, keep_top_k=40, top_k=128)
    for min_size in (None, 0.1):
        ref = JaxRealtimeDetector(None, JAX_TINY_SPEC, JaxRealtimeConfig(**cfg)).postprocess(jout, min_size)
        with torch.inference_mode():
            got = RealtimeDetector(tiny[2], RON_TINY_SPEC, RealtimeConfig(**cfg), device="cpu").postprocess(
                out, min_size)
        assert assert_head_equal(got, ref) > 0


@pytest.mark.parametrize("class_wise", [False, True])
def test_realtime_head_flushes_subnormal_scores(tiny, class_wise):
    """At thresholds of 0, candidates whose objectness, class probability or
    product is subnormal: 0 in the JAX package (XLA flushes subnormals on
    the CPU; the TPU has none), so never valid; the port flushes them too."""
    n = JAX_TINY_SPEC.anchor_layout().num_anchors
    out, _ = random_outputs(13, 2, n)
    preds, objness = out.predictions.clone(), out.objness_pred.clone()
    objness[0, :200] = 1e-20  # x probability -> a subnormal product
    objness[1, :100] = 1e-41  # subnormal itself
    preds[1, 100:300, 1:] = torch.where(preds[1, 100:300, 1:] > 0.5, 1e-39, preds[1, 100:300, 1:])
    arrays = [preds, out.logits, objness, out.objness_logits, out.locations]
    out = DetectorOutputs(*arrays)
    jout = JaxDetectorOutputs(*(jnp.asarray(a.numpy()) for a in arrays))
    kwargs = dict(select_threshold=0.0, objectness_threshold=0.0, top_k=n, keep_top_k=n, nms_threshold=1.0,
                  class_wise=class_wise, keep_per_class=n // 4)
    ref = JaxRealtimeDetector(None, JAX_TINY_SPEC, JaxRealtimeConfig(**kwargs)).postprocess(jout)
    with torch.inference_mode():
        got = RealtimeDetector(tiny[2], RON_TINY_SPEC, RealtimeConfig(**kwargs), device="cpu").postprocess(out)
    assert assert_head_equal(got, ref) > 0


@pytest.mark.parametrize("class_wise", [False, True])
def test_tiny_realtime_pixels_to_boxes_match_jax(tiny, class_wise):
    """Whiten + RealtimeDetector.__call__ on a tiny RON against JAX's, with
    per-image min sizes."""
    jmodel, jvars, model = tiny
    rng = np.random.default_rng(12)
    images = whitened(rng.uniform(0, 255, size=(3, 80, 72, 3)).astype(np.float32))
    min_size = np.array([0.03, 0.05, 0.02], np.float32)
    kwargs = dict(objectness_threshold=0.0, select_threshold=0.01, top_k=64, keep_top_k=16,
                  class_wise=class_wise, keep_per_class=10)
    with jax.default_matmul_precision("highest"):
        ref = JaxRealtimeDetector(jmodel, JAX_TINY_SPEC, JaxRealtimeConfig(**kwargs))(
            jvars, jnp.asarray(images), jnp.asarray(min_size))
    got = RealtimeDetector(model, RON_TINY_SPEC, RealtimeConfig(**kwargs), device="cpu")(images, min_size)
    assert assert_head_equal(got, ref) > 0


@pytest.mark.parametrize("has_objectness", [True, False])
@pytest.mark.parametrize("overrides", [{}, {"keep_top_k": 50, "objectness_threshold": 0.5}])
def test_realtime_config_for_spec_matches_jax(has_objectness, overrides):
    spec = dataclasses.replace(RON_TINY_SPEC, has_objectness=has_objectness)
    jspec = dataclasses.replace(JAX_TINY_SPEC, has_objectness=has_objectness)
    got = dataclasses.asdict(RealtimeConfig.for_spec(spec, **dict(overrides)))
    ref = dataclasses.asdict(JaxRealtimeConfig.for_spec(jspec, **dict(overrides)))
    assert got == ref
    assert got["class_wise"] == (not has_objectness)


def test_realtime_detector_defaults_to_cuda(tiny):
    """Without a `device`, the realtime head asks for CUDA; on a machine
    without a card it raises instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        RealtimeDetector(tiny[2], RON_TINY_SPEC)


# --------------------------------------------------------------------------- #
# full RON-320 against the reference's realtime detections (slow)


def fixture_model(case):
    """The port's f32 RON-320 with the weights of a fixture: the trained
    weights packed in it, or the reference's name-keyed pseudo-weights
    mapped in through the checkpoint import (tests/test_e2e_parity.py)."""
    model = RON(RON_320_SPEC)
    if case == "trained":
        if not os.path.exists(TRAINED_FIXTURE):
            pytest.fail(f"{TRAINED_FIXTURE} is missing")
        model.load_state_dict(from_jax_params(*load_trained_fixture(TRAINED_FIXTURE)), strict=True)
        return model, np.load(TRAINED_FIXTURE, allow_pickle=False)
    from ron_tensorflow_tpu.train.tf_checkpoint import slim_ron_to_flat

    sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "tools"))
    from reference_forward import weight_for

    ffx = np.load(FWD_FIXTURE, allow_pickle=False)
    names = [str(n) for n in ffx["var_names"]]
    shapes = json.loads(str(ffx["var_shapes"]))
    params, stats = slim_ron_to_flat({n: weight_for(n, s) for n, s in zip(names, shapes)})
    model.load_state_dict(from_jax_params(params, stats), strict=True)
    return model, np.load(E2E_FIXTURE, allow_pickle=False)


def realtime_config(fx, cfg_name):
    """tests/test_e2e_parity.py's two configs: the published flags with a
    sort cap of 2048, and the dense 'exercised' one."""
    if cfg_name == "published":
        return RealtimeConfig(top_k=2048)
    return RealtimeConfig(select_threshold=float(fx["rt_exercised_select"]),
                          objectness_threshold=float(fx["rt_exercised_objectness"]),
                          nms_threshold=0.3, keep_top_k=40, top_k=2048)


def sorted_rows(scores, labels, boxes):
    order = np.lexsort((boxes[:, 0], boxes[:, 1], labels, -scores))
    return scores[order], labels[order], boxes[order]


@pytest.mark.slow
@pytest.mark.parametrize("case", ["pseudo", "trained"])
def test_ron320_realtime_pixels_to_boxes_fixture_parity(case):
    """The assertions of tests/test_e2e_parity.py:195-201 applied to the
    port's realtime head: every image, both configs."""
    model, fx = fixture_model(case)
    checked = 0
    for img in IMAGES:
        pixels = fx[f"img_{img}_pixels"]
        h0, w0 = pixels.shape[:2]
        image = whiten(torch.as_tensor(tf1_bilinear_resize(pixels, (320, 320)) / 255.0))
        with torch.inference_mode():
            out = model(image[None])
        for cfg_name in ("published", "exercised"):
            cfg = realtime_config(fx, cfg_name)
            det = RealtimeDetector(model, RON_320_SPEC, cfg, device="cpu")
            min_size = np.float32(cfg.min_size * float(np.sqrt((h0 * w0) / (320.0 * 320.0))))
            with torch.inference_mode():
                scores, labels, boxes, valid = (t[0].numpy() for t in det.postprocess(out, min_size))
            got_s, got_l, got_b = sorted_rows(scores[valid], labels[valid], boxes[valid])
            tag = f"img_{img}_rt_{cfg_name}"
            ref_s, ref_l, ref_b = sorted_rows(fx[f"{tag}_scores"], fx[f"{tag}_labels"], fx[f"{tag}_boxes"])
            assert len(got_l) == len(ref_l), f"{tag}: kept {len(got_l)} vs reference {len(ref_l)}"
            np.testing.assert_array_equal(got_l, ref_l.astype(got_l.dtype))
            np.testing.assert_allclose(got_s, ref_s, atol=2e-3, rtol=0)
            np.testing.assert_allclose(got_b, ref_b, atol=2e-3, rtol=0)
            checked += len(ref_l)
    assert checked > 0
