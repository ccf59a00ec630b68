"""NMS rows of more than `kernels.nms.MAX_K` = 4096 candidates, on the CPU.

On the card such rows (a Detector's top_k at every anchor: 21250 for
RON-320, 8732 for SSD-300) go to the wide-row path of `csrc/nms_greedy.cu`,
held against the plain versions by tests/test_torch_cuda.py and
chip_smoke.py. Here the plain versions, which the CPU runs, are held to
the JAX package's TPU kernels in interpret mode (as its own tests run
them) on seeded rows of 2 x 4500, bit for bit: K-A (division-free,
uncapped) against `pallas_nms_fixpoint_keep_mask`, K-C (dividing, capped)
against `pallas_nms_keep_mask`. The tiny RON's Detector with a top_k at or
above its 850 anchors (a row of every anchor, then zero padding) is held to
JAX's on the same outputs, within test_torch_nms_method.py's 1e-5.
"""

import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ron_tensorflow_tpu.kernels.nms_pallas import pallas_nms_fixpoint_keep_mask, pallas_nms_keep_mask

from ron_tensorflow_tpu_torch.inference.detector import DetectionConfig, Detector
from ron_tensorflow_tpu_torch.kernels import nms as kernels_nms
from ron_tensorflow_tpu_torch.kernels.nms import MAX_K, nms_fixpoint_keep_mask, nms_scan_keep_mask
from ron_tensorflow_tpu_torch.models.spec import RON_TINY_SPEC

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_model import tiny  # noqa: E402,F401  (the module fixture)
from test_torch_nms_method import TOL, jax_detections, port_detections, tiny_outputs  # noqa: E402,F401

K = 4500
assert K > MAX_K


@pytest.fixture(scope="module")
def wide_rows():
    """Score-sorted rows of small boxes (sides 0.005-0.05) over the whole
    image: hundreds kept a row, some past candidate MAX_K."""
    rng = np.random.default_rng(45)
    cy, cx = rng.uniform(0.0, 1.0, (2, 2, K))
    h, w = rng.uniform(0.005, 0.05, (2, 2, K))
    boxes = np.stack([cy - h / 2, cx - w / 2, cy + h / 2, cx + w / 2], -1).astype(np.float32)
    scores = np.where(rng.uniform(size=(2, K)) < 0.05, 0.0, rng.uniform(0.01, 1, (2, K)))  # 0s sort last
    order = np.argsort(-scores, axis=-1, kind="stable")
    return (np.take_along_axis(scores, order, -1).astype(np.float32),
            np.take_along_axis(boxes, order[..., None], -2))


def test_fixpoint_plain_equals_pallas_on_wide_rows(wide_rows):
    """K-A's plain version (the CPU path of `nms_fixpoint_keep_mask`) at
    K = 4500, 'min' mode (the Detector's)."""
    scores, boxes = wide_rows
    ref = np.asarray(pallas_nms_fixpoint_keep_mask(jnp.asarray(scores), jnp.asarray(boxes), 0.4, "min",
                                                   interpret=True))
    got = nms_fixpoint_keep_mask(torch.as_tensor(scores), torch.as_tensor(boxes), 0.4, "min").numpy()
    np.testing.assert_array_equal(got, ref)
    assert 20 < ref.sum() and ref[:, MAX_K:].any()  # candidates past the old limit kept


@pytest.mark.parametrize("rows_at_once", [1, 2, 5])
def test_fixpoint_plain_in_groups_of_rows_equals_one_group(monkeypatch, wide_rows, rows_at_once):
    """K-A's plain version builds its [R, K, K] overlaps for at most
    PLAIN_PAIRS pairs at once (a row at a time at K = 21250): groups of 1, 2
    and all 5 rows give the same mask."""
    scores, boxes = (torch.as_tensor(np.tile(a[:, :300], (3,) + (1,) * (a.ndim - 1))[:5]) for a in wide_rows)
    want = kernels_nms.fixpoint_keep(scores > 0.0, kernels_nms.suppression_matrix(boxes, 0.4, "union"))[0]
    monkeypatch.setattr(kernels_nms, "PLAIN_PAIRS", rows_at_once * 300 * 300)
    np.testing.assert_array_equal(kernels_nms.nms_fixpoint_keep_mask_plain(scores, boxes, 0.4, "union"), want)
    assert 0 < int(want.sum()) < want.numel()


@pytest.mark.parametrize("mode,keep_top_k", [("union", 200), ("min", 20), ("min", K)])
def test_scan_plain_equals_pallas_on_wide_rows(wide_rows, mode, keep_top_k):
    """K-C's plain version at K = 4500, capped at 20, 200 and K."""
    scores, boxes = wide_rows
    ref = np.asarray(pallas_nms_keep_mask(jnp.asarray(scores), jnp.asarray(boxes), 0.4, keep_top_k, mode,
                                          interpret=True))
    got = nms_scan_keep_mask(torch.as_tensor(scores), torch.as_tensor(boxes), 0.4, keep_top_k, mode).numpy()
    np.testing.assert_array_equal(got, ref)
    assert 0 < ref.sum(-1).max() <= keep_top_k


@pytest.mark.parametrize("top_k", [850, 1000], ids=["every anchor", "padded"])
def test_detector_with_top_k_at_every_anchor_matches_jax(tiny, tiny_outputs, top_k):
    """`DetectionConfig(top_k >= anchors)`: rows of every anchor, padded
    with zero scores past them, as JAX's Detector takes k = min(top_k,
    anchors) (`inference/detector.py:225`). Method 'fixpoint' (K-C's plain
    version here, JAX's `nms_sorted_fixpoint`): JAX's 'loop' runs its
    K-step fori_loop for minutes under a loaded tier-1 run."""
    assert RON_TINY_SPEC.anchor_layout().num_anchors == 850
    ref_out, out = tiny_outputs
    cfg = dict(nms_method="fixpoint", top_k=top_k, objectness_threshold=0.0)
    ref_s, ref_b = jax_detections(tiny[0], ref_out, **cfg)
    got_s, got_b = port_detections(tiny[2], out, **cfg)
    rows, _ = Detector(tiny[2], RON_TINY_SPEC, DetectionConfig(**cfg), device="cpu").candidates(out)
    assert rows.shape == (out.predictions.shape[0] * 20, top_k)
    ref_n = (ref_s > 0).sum(-1)
    assert ref_n.sum() > 0
    np.testing.assert_array_equal((got_s > 0).sum(-1), ref_n)
    np.testing.assert_allclose(got_s, ref_s, rtol=0, atol=TOL)
    np.testing.assert_allclose(got_b, ref_b, rtol=0, atol=TOL)
