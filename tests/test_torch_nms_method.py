"""The Detector's `nms_method` and `split_apply`, and `ops/nms.py`'s
`nms_sorted`, `nms_sorted_fixpoint` and `nms`, against the JAX package on
the CPU (JAX's 'pallas' in interpret mode, as its own tests run it).

JAX's 'loop' and 'fixpoint' divide (`overlap_matrix >= t`); its Pallas
kernel, like the port's K-A, compares `inter >= t * denom`. The two part on
a pair whose overlap lies within one rounding of the threshold.
`near_threshold_locations` and `outputs_with_pair` build network outputs
that hold such a pair (the two boxes decoded alike by both packages): JAX's CPU Detector under 'auto'
(its loop) keeps both boxes and K-A suppresses the second. Before the
port's 'auto' followed JAX's on the CPU, the port's CPU Detector ran K-A
there and kept one; now 'auto' runs K-C's plain version on CPU rows.

Tolerances: the NMS functions and the Detector on the built outputs are
compared bit for bit (the same boxes go in); on the tiny RON's outputs,
keep counts are equal and scores and boxes within 1e-5 absolute (the two
decoders may part by an ulp), as in test_torch_shared_top_k.py.
"""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ron_tensorflow_tpu.inference.detector import DetectionConfig as JaxDetectionConfig
from ron_tensorflow_tpu.inference.detector import Detector as JaxDetector
from ron_tensorflow_tpu.models.ron import DetectorOutputs as JaxDetectorOutputs
from ron_tensorflow_tpu.models.testing import RON_TINY_SPEC as JAX_TINY_SPEC
from ron_tensorflow_tpu.ops import boxes as jax_boxes
from ron_tensorflow_tpu.ops import nms as jax_nms
from ron_tensorflow_tpu.ops.decode import decode_boxes as jax_decode_boxes

from ron_tensorflow_tpu_torch.inference.detector import NMS_METHODS, DetectionConfig, Detector
from ron_tensorflow_tpu_torch.kernels.nms import nms_fixpoint_keep_mask_plain, nms_scan_keep_mask_plain
from ron_tensorflow_tpu_torch.models.ron import DetectorOutputs
from ron_tensorflow_tpu_torch.models.spec import RON_TINY_SPEC
from ron_tensorflow_tpu_torch.ops import boxes as boxops
from ron_tensorflow_tpu_torch.ops import nms as port_nms
from ron_tensorflow_tpu_torch.ops.decode import decode_boxes

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_kernels import random_rows  # noqa: E402
from test_torch_model import _whitened, tiny  # noqa: E402,F401  (the module fixture)

TOL = 1e-5
THRESHOLD = 0.4  # DetectionConfig's nms_threshold, 'min' mode
# Two boxes 0.5 x 0.32 whose 'min' overlap is 0.4: the areas lie in
# [0.15625, 0.1667), where an f32 `inter / denom` and `t * denom` can round
# to opposite sides of the threshold (they cannot at every area).
BOX_A = (0.2, 0.2, 0.7, 0.52)
BOX_B = (0.2, 0.392, 0.7, 0.712)


def encode(box, anchor, prior_scaling):
    """The location offsets (cx, cy, w, h) that decode to `box` at `anchor` (cy, cx, h, w)."""
    y0, x0, y1, x1 = box
    acy, acx, ah, aw = anchor
    s0, s1, s2, s3 = prior_scaling
    return np.array([((x0 + x1) / 2 - acx) / (aw * s0), ((y0 + y1) / 2 - acy) / (ah * s1),
                     np.log((x1 - x0) / aw) / s2, np.log((y1 - y0) / ah) / s3], np.float32)


def both_decoders(locations, anchors, prior_scaling):
    """Clipped boxes of both packages' decoders."""
    ref = jax_boxes.clip_to_ref(jax_decode_boxes(jnp.asarray(locations), jnp.asarray(anchors), prior_scaling))
    got = boxops.clip_to_ref(decode_boxes(torch.as_tensor(locations), torch.as_tensor(anchors), prior_scaling))
    return np.asarray(ref), got.numpy()


def predicates(b):
    """For boxes b [T, 2, 4]: (the dividing predicate, the division-free
    one) of pair (0, 1) in 'min' mode, float32, as the kernels compute them."""
    f = np.float32
    ih = np.maximum(np.minimum(b[:, 0, 2], b[:, 1, 2]) - np.maximum(b[:, 0, 0], b[:, 1, 0]), f(0))
    iw = np.maximum(np.minimum(b[:, 0, 3], b[:, 1, 3]) - np.maximum(b[:, 0, 1], b[:, 1, 1]), f(0))
    inter = ih * iw
    vol = (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])
    denom = np.minimum(vol[:, 0], vol[:, 1])
    t = f(THRESHOLD)
    return inter / denom >= t, inter >= t * denom


def near_threshold_locations(seed=0, trials=1 << 14):
    """Location offsets of anchors 0 and 1 [2, 4] whose decoded boxes (the
    same in both packages) the two predicates judge apart: BOX_A and BOX_B
    encoded, each offset moved by up to 40 float32 ulps, seeded."""
    anchors = RON_TINY_SPEC.anchor_layout().cyxhw[:2].astype(np.float32)
    ps = RON_TINY_SPEC.prior_scaling
    base = np.stack([encode(BOX_A, anchors[0], ps), encode(BOX_B, anchors[1], ps)])
    rng = np.random.default_rng(seed)
    locs = base + rng.integers(-40, 41, (trials, 2, 4)) * np.spacing(np.abs(base))
    locs = locs.astype(np.float32)
    ref, got = both_decoders(locs, anchors, ps)
    divides, division_free = predicates(got)
    hits = np.nonzero((ref == got).all(axis=(1, 2)) & (divides != division_free))[0]
    assert hits.size, "no near-threshold pair among the trials"
    return locs[hits[0]]


def outputs_with_pair(locs, n_anchors, num_classes=21):
    """Network outputs of one image: anchors 0 and 1 hold the pair, class 1
    at 0.9 and 0.8; every other anchor is background (score 0 after the
    select threshold); objectness 1."""
    loc = np.zeros((1, n_anchors, 4), np.float32)
    loc[0, :2] = locs
    pred = np.zeros((1, n_anchors, num_classes), np.float32)
    pred[0, :, 0] = 1.0
    pred[0, :2, 0] = (0.1, 0.2)
    pred[0, :2, 1] = (0.9, 0.8)
    logits = np.log(np.maximum(pred, 1e-30))
    objness = np.ones((1, n_anchors), np.float32)
    objness_logits = np.stack([np.zeros_like(objness), objness * 1e3], -1)
    fields = dict(predictions=pred, logits=logits, objness_pred=objness, objness_logits=objness_logits, locations=loc)
    return (JaxDetectorOutputs(**{k: jnp.asarray(v) for k, v in fields.items()}),
            DetectorOutputs(**{k: torch.as_tensor(v) for k, v in fields.items()}))


@pytest.fixture(scope="module")
def pair_outputs():
    return outputs_with_pair(near_threshold_locations(), RON_TINY_SPEC.anchor_layout().num_anchors)


def jax_detections(jmodel, ref_out, **cfg):
    jdet = JaxDetector(jmodel, JAX_TINY_SPEC, JaxDetectionConfig(**cfg))
    return [np.asarray(a) for a in jax.jit(jdet.postprocess)(ref_out)]


def port_detections(model, out, **cfg):
    with torch.inference_mode():
        det = Detector(model, RON_TINY_SPEC, DetectionConfig(**cfg), device="cpu")
        return [t.numpy() for t in det.postprocess(out)]


def test_near_threshold_row_parts_the_two_predicates(pair_outputs):
    """On the Detector's NMS row of the built outputs, K-C's plain version
    (dividing) keeps both boxes and K-A's (division-free) suppresses the
    second."""
    _, out = pair_outputs
    det = Detector(torch.nn.Identity(), RON_TINY_SPEC, DetectionConfig(), device="cpu")
    s, b = det.candidates(out)
    row = s[:1], b[:1].contiguous()  # class 1 of the image
    assert row[0][0, :3].tolist() == pytest.approx([0.9, 0.8, 0.0])
    assert nms_scan_keep_mask_plain(*row, THRESHOLD, 100, "min")[0, :2].tolist() == [True, True]
    assert nms_fixpoint_keep_mask_plain(*row, THRESHOLD, "min")[0, :2].tolist() == [True, False]


@pytest.mark.parametrize("method", NMS_METHODS)
def test_detector_matches_jax_on_the_near_threshold_pair(tiny, pair_outputs, method):
    """Each method against JAX's on the CPU, bit for bit: 'auto', 'loop'
    and 'fixpoint' keep both boxes, 'pallas' keeps one, in both packages."""
    ref_out, out = pair_outputs
    ref = jax_detections(tiny[0], ref_out, nms_method=method)
    got = port_detections(tiny[2], out, nms_method=method)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, r)
    assert int((got[0][0, 0] > 0).sum()) == (1 if method == "pallas" else 2)
    assert int((got[0] > 0).sum()) == int((got[0][0, 0] > 0).sum())  # no other class keeps anything


@pytest.fixture(scope="module")
def tiny_outputs(tiny):
    """The tiny RON's outputs of the whitened pixels in both packages' types."""
    _, _, model, pixels = tiny
    with torch.inference_mode():
        got = model(torch.as_tensor(_whitened(pixels)))
    return JaxDetectorOutputs(**{f: jnp.asarray(getattr(got, f).numpy()) for f in JaxDetectorOutputs._fields}), got


@pytest.mark.parametrize("split_apply", [False, True], ids=["fused", "split"])
@pytest.mark.parametrize("method", NMS_METHODS)
def test_detector_methods_match_jax_on_tiny_outputs(tiny, tiny_outputs, method, split_apply):
    """Each method (and `split_apply`, which changes nothing in either
    package's results) against JAX's on the tiny RON's outputs."""
    ref_out, out = tiny_outputs
    ref_s, ref_b = jax_detections(tiny[0], ref_out, nms_method=method, split_apply=split_apply)
    got_s, got_b = port_detections(tiny[2], out, nms_method=method, split_apply=split_apply)
    ref_n = (ref_s > 0).sum(-1)
    assert ref_n.sum() > 0
    np.testing.assert_array_equal((got_s > 0).sum(-1), ref_n)
    np.testing.assert_allclose(got_s, ref_s, rtol=0, atol=TOL)
    np.testing.assert_allclose(got_b, ref_b, rtol=0, atol=TOL)


def test_detector_method_follows_the_rows_device():
    det = Detector(torch.nn.Identity(), RON_TINY_SPEC, DetectionConfig(), device="cpu")
    cpu, meta = torch.zeros(2, 4), torch.zeros(2, 4, device="meta")
    picks = {}
    for method in NMS_METHODS:
        det.config = DetectionConfig(nms_method=method)
        picks[method] = (det.keep_mask_kernel(cpu), det.keep_mask_kernel(meta))
    # a 'meta' tensor stands for a non-CPU device: only 'auto' looks at the device, and only CUDA rows get K-A
    assert picks == {"auto": ("scan", "scan"), "loop": ("scan", "scan"), "fixpoint": ("scan", "scan"),
                     "pallas": ("fixpoint", "fixpoint")}
    with pytest.raises(ValueError, match="unknown nms_method"):
        Detector(torch.nn.Identity(), RON_TINY_SPEC, DetectionConfig(nms_method="xla"), device="cpu")


NMS_ROWS = [
    # (seed, rows, K, grid, threshold, mode)
    (0, 6, 64, None, 0.45, "min"),
    (1, 8, 200, None, 0.4, "union"),
    (2, 6, 96, 8, 0.5, "min"),  # exact-threshold hits on a 1/8 grid
    (3, 6, 96, 4, 0.25, "union"),
]


@pytest.mark.parametrize("fn", ["nms_sorted", "nms_sorted_fixpoint"])
@pytest.mark.parametrize("seed,r,k,grid,thr,mode", NMS_ROWS)
def test_nms_sorted_functions_equal_jax(fn, seed, r, k, grid, thr, mode):
    """Score-sorted rows, batched against JAX's vmapped function and one
    row against JAX's on one row, bit for bit, keep_top_k below and above
    the kept count."""
    scores, boxes = random_rows(seed, r, k, grid)
    for keep_top_k in (5, 40):
        ref = jax.vmap(lambda s, b: getattr(jax_nms, fn)(s, b, thr, keep_top_k, mode))(
            jnp.asarray(scores), jnp.asarray(boxes))
        got = getattr(port_nms, fn)(torch.as_tensor(scores), torch.as_tensor(boxes), thr, keep_top_k, mode)
        for g, rr in zip(got, ref):
            np.testing.assert_array_equal(g.numpy(), np.asarray(rr))
        one = getattr(port_nms, fn)(torch.as_tensor(scores[0]), torch.as_tensor(boxes[0]), thr, keep_top_k, mode)
        for g, rr in zip(one, ref):
            np.testing.assert_array_equal(g.numpy(), np.asarray(rr)[0])


@pytest.mark.parametrize("seed,r,k,grid,thr,mode", NMS_ROWS)
def test_nms_of_unsorted_rows_equals_jax(seed, r, k, grid, thr, mode):
    """`nms` sorts first: the rows shuffled, top_k below and above K."""
    scores, boxes = random_rows(seed, r, k, grid)
    perm = np.random.default_rng(seed).permutation(k)
    scores, boxes = scores[:, perm], boxes[:, perm]
    for top_k in (k // 2, k + 8):
        ref = jax.vmap(lambda s, b: jax_nms.nms(s, b, thr, top_k, 20, mode))(jnp.asarray(scores), jnp.asarray(boxes))
        got = port_nms.nms(torch.as_tensor(scores), torch.as_tensor(boxes), thr, top_k, 20, mode)
        for g, rr in zip(got, ref):
            np.testing.assert_array_equal(g.numpy(), np.asarray(rr))
        one = port_nms.nms(torch.as_tensor(scores[1]), torch.as_tensor(boxes[1]), thr, top_k, 20, mode)
        for g, rr in zip(one, ref):
            np.testing.assert_array_equal(g.numpy(), np.asarray(rr)[1])


@pytest.mark.parametrize("fn", ["nms_sorted", "nms_sorted_fixpoint", "nms"])
def test_nms_functions_keep_the_near_threshold_pair_as_jax(fn, pair_outputs):
    """The built pair as a row of two: JAX's dividing functions keep both,
    and so do the port's."""
    _, out = pair_outputs
    boxes = boxops.clip_to_ref(decode_boxes(out.locations[0, :2], torch.as_tensor(
        RON_TINY_SPEC.anchor_layout().cyxhw[:2]), RON_TINY_SPEC.prior_scaling))
    scores = torch.tensor([0.9, 0.8])
    extra = (400,) if fn == "nms" else ()
    ref = getattr(jax_nms, fn)(jnp.asarray(scores.numpy()), jnp.asarray(boxes.numpy()), THRESHOLD, *extra, 10, "min")
    got = getattr(port_nms, fn)(scores, boxes, THRESHOLD, *extra, 10, "min")
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    assert int((got[0] > 0).sum()) == 2
