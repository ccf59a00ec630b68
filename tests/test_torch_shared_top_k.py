"""The Detector's selection knobs (`shared_top_k`, `approx_top_k`,
`topk_chunks`) against the JAX Detector with the same config, on the
outputs of the tiny RON of `test_torch_model.py` (seeded numpy weights and
pixels; the forward's own parity is held there): both postprocess the same
network outputs, JAX's with the Pallas fixpoint NMS in interpret mode.

At the objectness threshold used here about 175 of the 850 anchors of
each image pass the gate, so a preselection of 120 drops gated anchors
and one of 300 takes about 125 anchors whose preselection score is 0:
their order, and the boxes they carry into the 0-score slots of the NMS
rows, follow `lax.top_k`'s ties (lowest index first). Every slot is
compared: keep counts equal, scores and boxes within 1e-5 absolute."""

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

from ron_tensorflow_tpu_torch.inference.detector import DetectionConfig, Detector
from ron_tensorflow_tpu_torch.models.spec import RON_TINY_SPEC

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_model import _whitened, tiny  # noqa: E402,F401  (the module fixture)

OBJECTNESS = 0.9
N_ANCHORS = 850


@pytest.fixture(scope="module")
def outputs(tiny):
    """The port's network outputs of the whitened pixels, and the same
    numbers as JAX's `DetectorOutputs`."""
    _, _, model, pixels = tiny
    with torch.inference_mode():
        got = model(torch.as_tensor(_whitened(pixels)))
    return JaxDetectorOutputs(**{f: jnp.asarray(getattr(got, f).numpy()) for f in JaxDetectorOutputs._fields}), got


def detections_match_jax(tiny, outputs, **knobs):
    jmodel, _, model, _ = tiny
    ref_out, got_out = outputs
    cfg = dict(objectness_threshold=OBJECTNESS, **knobs)
    jdet = JaxDetector(jmodel, JAX_TINY_SPEC, JaxDetectionConfig(nms_method="pallas", **cfg))
    ref_s, ref_b = (np.asarray(a) for a in jax.jit(jdet.postprocess)(ref_out))
    with torch.inference_mode():
        det = Detector(model, RON_TINY_SPEC, DetectionConfig(**cfg), device="cpu")
        got_s, got_b = (t.numpy() for t in det.postprocess(got_out))
    assert got_s.shape == ref_s.shape and got_b.shape == ref_b.shape
    ref_n = (ref_s > 0).sum(-1)
    assert ref_n.sum() > 0
    np.testing.assert_array_equal((got_s > 0).sum(-1), ref_n)  # keep counts per (image, class)
    np.testing.assert_allclose(got_s, ref_s, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got_b, ref_b, rtol=0, atol=1e-5)


def test_gate_leaves_fewer_anchors_than_the_larger_preselection(tiny, outputs):
    """The premise of the cases below: 120 < anchors through the gate < 300."""
    _, got = outputs
    det = Detector(tiny[2], RON_TINY_SPEC, DetectionConfig(objectness_threshold=OBJECTNESS), device="cpu")
    scores, boxes = det.class_scores(got)
    assert scores.shape[-1] == boxes.shape[1] == N_ANCHORS
    gated = (got.objness_pred > OBJECTNESS).sum(dim=1)
    assert ((gated > 120) & (gated < 300)).all(), gated.tolist()


@pytest.mark.parametrize("approx_top_k", [False, True], ids=["exact", "approx"])
@pytest.mark.parametrize("shared_top_k", [120, 300, N_ANCHORS], ids=["K120", "K300", "K_ge_N"])
def test_shared_top_k_matches_jax(tiny, outputs, shared_top_k, approx_top_k):
    detections_match_jax(tiny, outputs, shared_top_k=shared_top_k, approx_top_k=approx_top_k)


@pytest.mark.parametrize("topk_chunks", [0, 2, 16])
def test_topk_chunks_match_jax(tiny, outputs, topk_chunks):
    """2 chunks split the preselection (2 x 120 < 850 anchors); 0 and 16
    select each row whole at these sizes."""
    detections_match_jax(tiny, outputs, shared_top_k=120, topk_chunks=topk_chunks)


@pytest.mark.parametrize("shared_top_k", [120, 300], ids=["K120", "K300"])
def test_nms_rows_match_jax_tie_order_included(tiny, outputs, monkeypatch, shared_top_k):
    """The rows that reach NMS, every slot: JAX's postprocess with its NMS
    replaced by the identity gives its candidates. At K=300 the 0-score slots hold the boxes of preselected
    anchors that the gate closed, in `lax.top_k`'s tie order at both
    stages; the scores are gathered, so they are equal bit for bit."""
    import ron_tensorflow_tpu.kernels as jax_kernels

    jmodel, _, model, _ = tiny
    ref_out, got_out = outputs
    cfg = dict(objectness_threshold=OBJECTNESS, shared_top_k=shared_top_k, keep_top_k=200)
    monkeypatch.setattr(jax_kernels, "nms_sorted_pallas", lambda s, b, *args, **kwargs: (s, b))
    jdet = JaxDetector(jmodel, JAX_TINY_SPEC, JaxDetectionConfig(nms_method="pallas", **cfg))
    ref_s, ref_b = (np.asarray(a).reshape(-1, *a.shape[2:]) for a in jax.jit(jdet.postprocess)(ref_out))
    with torch.inference_mode():
        got_s, got_b = (t.numpy() for t in Detector(model, RON_TINY_SPEC, DetectionConfig(**cfg),
                                                      device="cpu").candidates(got_out))
    zero = ref_s == 0
    assert zero.any() and (np.abs(ref_b[zero]).sum(-1) > 0).any()  # 0-score slots with real boxes
    np.testing.assert_array_equal(got_s, ref_s)
    np.testing.assert_allclose(got_b, ref_b, rtol=0, atol=1e-5)
