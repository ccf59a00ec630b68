"""The port's sequential-scan NMS (K-C) against the JAX package's Pallas
scan kernel `pallas_nms_keep_mask` in interpret mode, on the CPU: the plain
version's mask must equal the TPU kernel's bit for bit, exact-threshold
rows included. The CUDA kernel is held against the plain version on the
card (tests/test_torch_cuda.py, chip_smoke.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ron_tensorflow_tpu.kernels.nms_pallas import nms_sorted_pallas, pallas_nms_keep_mask

from ron_tensorflow_tpu_torch import kernels
from ron_tensorflow_tpu_torch.kernels import nms_scan_keep_mask, nms_scan_keep_mask_plain, nms_sorted_kernel


def random_rows(seed, r, n, grid=None, zero_share=0.2):
    """Score-sorted rows whose last candidates have score 0 (about
    zero_share of them). grid=g snaps coordinates to multiples of 1/g, so
    the overlaps land exactly on thresholds like 0.5 and 0.25."""
    rng = np.random.default_rng(seed)
    cy, cx = rng.uniform(0.2, 0.8, (2, r, n))
    h, w = rng.uniform(0.05, 0.4, (2, r, n))
    boxes = np.stack([cy - h / 2, cx - w / 2, cy + h / 2, cx + w / 2], -1)
    if grid:
        boxes = np.round(boxes * grid) / grid
    scores = np.where(rng.uniform(size=(r, n)) < zero_share, 0.0, rng.uniform(0.01, 1, (r, n)))
    order = np.argsort(-scores, axis=-1, kind="stable")
    scores = np.take_along_axis(scores, order, axis=-1).astype(np.float32)
    boxes = np.take_along_axis(boxes, order[..., None], axis=-2).astype(np.float32)
    return scores, boxes


def pallas_mask(scores, boxes, thr, keep_top_k, mode):
    return np.asarray(
        pallas_nms_keep_mask(jnp.asarray(scores), jnp.asarray(boxes), thr, keep_top_k, mode, interpret=True)
    )


SCAN_CASES = [
    # (seed, rows, K, grid, threshold, keep_top_k)
    (0, 13, 200, None, 0.4, 100),  # R not a multiple of 8, K not of 128; the main path's K and threshold
    (1, 5, 31, None, 0.45, 200),  # keep_top_k above K
    (2, 16, 96, 8, 0.5, 200),  # exact-threshold hits on a 1/8 grid
    (3, 16, 96, 4, 0.25, 200),
    (4, 8, 200, None, 0.7, 16),  # a cap that binds: 16 of 200
]


@pytest.mark.parametrize("mode", ["min", "union"])
@pytest.mark.parametrize("seed,r,k,grid,thr,cap", SCAN_CASES)
def test_scan_plain_matches_pallas_bit_for_bit(seed, r, k, grid, thr, cap, mode):
    scores, boxes = random_rows(seed, r, k, grid)
    ref = pallas_mask(scores, boxes, thr, cap, mode)
    got = nms_scan_keep_mask_plain(torch.as_tensor(scores), torch.as_tensor(boxes), thr, cap, mode)
    np.testing.assert_array_equal(got.numpy(), ref)
    assert int(got.sum(-1).max()) <= cap
    kernels.reset_launch_counts()
    via_wrapper = nms_scan_keep_mask(torch.as_tensor(scores), torch.as_tensor(boxes), thr, cap, mode)
    torch.testing.assert_close(via_wrapper, got, rtol=0, atol=0)
    assert nms_scan_keep_mask.launches == 0  # a CPU tensor runs the plain version


def test_scan_cap_binds_and_zero_tails_are_dropped():
    """With 16 of 200 kept the cap binds on every row; zero-score
    candidates (a third of each row, at its end) are never kept."""
    scores, boxes = random_rows(5, 6, 200, zero_share=0.35)
    boxes[..., 2:] = boxes[..., :2] + 0.01  # tiny boxes: almost nothing is suppressed
    got = nms_scan_keep_mask_plain(torch.as_tensor(scores), torch.as_tensor(boxes), 0.5, 16, "min")
    np.testing.assert_array_equal(got.numpy(), pallas_mask(scores, boxes, 0.5, 16, "min"))
    assert got.sum(-1).tolist() == [16] * 6
    uncapped = nms_scan_keep_mask_plain(torch.as_tensor(scores), torch.as_tensor(boxes), 0.5, 200, "min")
    assert not (uncapped & torch.as_tensor(scores <= 0)).any()
    np.testing.assert_array_equal(uncapped.numpy(), pallas_mask(scores, boxes, 0.5, 200, "min"))


def test_scan_exact_threshold_rows_do_hit():
    """A pair whose overlap equals the threshold exactly is suppressed
    (ov >= t), in both modes, as in the TPU scan kernel."""
    boxes = np.array([[[0.0, 0.0, 0.5, 0.5], [0.0, 0.25, 0.5, 0.75], [0.5, 0.5, 1.0, 1.0]]], np.float32)
    scores = np.array([[0.9, 0.8, 0.7]], np.float32)
    # second box: inter 0.125, min-area 0.25 (overlap 0.5), union 0.375 (1/3)
    for mode, thr in (("min", 0.5), ("union", 1.0 / 3.0)):
        got = nms_scan_keep_mask_plain(torch.as_tensor(scores), torch.as_tensor(boxes), thr, 200, mode)
        np.testing.assert_array_equal(got.numpy(), pallas_mask(scores, boxes, thr, 200, mode))
        assert got.tolist() == [[True, False, True]]


@pytest.mark.parametrize("seed,r,k,grid,thr,cap", SCAN_CASES)
def test_nms_sorted_kernel_scan_matches_nms_sorted_pallas(seed, r, k, grid, thr, cap):
    scores, boxes = random_rows(seed, r, k, grid)
    keep_top_k = min(cap, 16)
    ref_s, ref_b = nms_sorted_pallas(
        jnp.asarray(scores), jnp.asarray(boxes), thr, keep_top_k, "min", interpret=True, method="scan"
    )
    got_s, got_b = nms_sorted_kernel(
        torch.as_tensor(scores), torch.as_tensor(boxes), thr, keep_top_k, "min", method="scan"
    )
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(ref_s))
    np.testing.assert_array_equal(got_b.numpy(), np.asarray(ref_b))


def test_nms_sorted_kernel_rejects_unknown_method():
    scores, boxes = random_rows(6, 1, 8)
    with pytest.raises(ValueError):
        nms_sorted_kernel(torch.as_tensor(scores), torch.as_tensor(boxes), 0.5, 4, "min", method="loop")
