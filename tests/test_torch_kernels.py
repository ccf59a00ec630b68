"""The port's kernels' plain versions, and the NMS ops around them, against
the JAX package's Pallas kernels (interpret mode) and XLA references on
the CPU. The CUDA kernels themselves are held against these plain versions
on the card (tests/test_torch_cuda.py, chip_smoke.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ron_tensorflow_tpu.kernels import fused_vgg_block1 as jax_fused_vgg_block1
from ron_tensorflow_tpu.kernels.fused_conv_pool import _block1_xla_reference
from ron_tensorflow_tpu.kernels.nms_pallas import (
    nms_sorted_pallas,
    pallas_nms_fixpoint_keep_mask,
)
from ron_tensorflow_tpu.ops import nms as jax_nms

from ron_tensorflow_tpu_torch import kernels
from ron_tensorflow_tpu_torch.kernels import (
    fused_vgg_block1,
    fused_vgg_block1_plain,
    nms_fixpoint_keep_mask,
    nms_fixpoint_keep_mask_plain,
    nms_sorted_kernel,
)
from ron_tensorflow_tpu_torch.kernels.nms import fixpoint_keep, suppression_matrix


def oihw(w_hwio):
    return torch.as_tensor(np.asarray(w_hwio)).permute(3, 2, 0, 1).contiguous()


def block1_inputs(seed, shape, cin, c=8):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(*shape, cin)).astype(np.float32)
    w1 = (rng.normal(size=(3, 3, cin, c)) * 0.2).astype(np.float32)
    b1 = rng.normal(size=(c,)).astype(np.float32)
    w2 = (rng.normal(size=(3, 3, c, c)) * 0.1).astype(np.float32)
    b2 = rng.normal(size=(c,)).astype(np.float32)
    return x, w1, b1, w2, b2


def run_plain(x, w1, b1, w2, b2, dtype=torch.float32):
    return fused_vgg_block1_plain(
        torch.as_tensor(x).to(dtype), oihw(w1), torch.as_tensor(b1), oihw(w2), torch.as_tensor(b2)
    )


# The shapes of tests/test_fused_conv_pool.py::test_fused_block1_parity_interpret:
# (1, 64, 8) spans two 32-row tiles of the TPU kernel; cin=8 is rectangular.
BLOCK1_SHAPES = [((2, 16, 16), 3), ((1, 64, 8), 3), ((1, 16, 16), 8)]


@pytest.mark.parametrize("shape,cin", BLOCK1_SHAPES)
def test_block1_plain_matches_pallas_interpret(shape, cin):
    """Same numerics as the TPU kernel (bf16 inputs and conv1_1 output, f32
    sums): the two differ only by summation order, which can move a value
    across a bf16 rounding boundary: at most one bf16 ulp (2^-8 relative)
    of the output, plus what a re-rounded conv1_1 value carries through."""
    args = block1_inputs(2, shape, cin)
    ref = np.asarray(jax_fused_vgg_block1(*map(jnp.asarray, args), interpret=True))
    got = run_plain(*args).numpy()
    assert got.shape == ref.shape == (shape[0], shape[1] // 2, shape[2] // 2, 8)
    np.testing.assert_allclose(got, ref, rtol=1e-2, atol=1e-2)


@pytest.mark.parametrize("shape,cin", BLOCK1_SHAPES)
def test_block1_plain_matches_xla_reference(shape, cin):
    """The XLA composition in bf16 rounds each conv's output and adds the
    bias in bf16, so it sits a few bf16 ulps away: the tolerance of
    tests/test_fused_conv_pool.py."""
    args = block1_inputs(3, shape, cin)
    x = jnp.asarray(args[0], jnp.bfloat16)
    ref = np.asarray(_block1_xla_reference(x, *map(jnp.asarray, args[1:])).astype(jnp.float32))
    got = run_plain(*args, dtype=torch.bfloat16).float().numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-2, atol=5e-2)


def test_block1_wrapper_runs_plain_on_cpu_without_counting():
    args = block1_inputs(4, (1, 8, 12), 3, c=64)
    kernels.reset_launch_counts()
    x = torch.as_tensor(args[0]).to(torch.bfloat16)
    weights = (oihw(args[1]), torch.as_tensor(args[2]), oihw(args[3]), torch.as_tensor(args[4]))
    out = fused_vgg_block1(x, *weights)
    assert out.dtype == torch.bfloat16 and out.shape == (1, 4, 6, 64)
    torch.testing.assert_close(out, fused_vgg_block1_plain(x, *weights), rtol=0, atol=0)
    assert kernels.launch_counts() == {"nms_fixpoint_keep_mask": 0, "fused_vgg_block1": 0}


# --------------------------------------------------------------------------- #
# NMS


def random_rows(seed, r=6, n=64, grid=None):
    """Score-sorted rows with some zero scores. grid=g snaps coordinates to
    multiples of 1/g, so products are exact and overlaps land exactly on
    thresholds like 0.5 and 0.25."""
    rng = np.random.default_rng(seed)
    cy, cx = rng.uniform(0.2, 0.8, (2, r, n))
    h, w = rng.uniform(0.05, 0.4, (2, r, n))
    boxes = np.stack([cy - h / 2, cx - w / 2, cy + h / 2, cx + w / 2], -1)
    if grid:
        boxes = np.round(boxes * grid) / grid
    scores = np.where(rng.uniform(size=(r, n)) < 0.2, 0.0, rng.uniform(0.01, 1, (r, n)))
    order = np.argsort(-scores, axis=-1, kind="stable")
    scores = np.take_along_axis(scores, order, axis=-1).astype(np.float32)
    boxes = np.take_along_axis(boxes, order[..., None], axis=-2).astype(np.float32)
    return scores, boxes


NMS_CASES = [
    # (seed, rows, K, grid, threshold)
    (0, 6, 64, None, 0.45),
    (1, 40, 200, None, 0.4),  # the main path's K and threshold
    (2, 16, 96, 8, 0.5),  # exact-threshold hits on a 1/8 grid
    (3, 16, 96, 4, 0.25),
]


@pytest.mark.parametrize("mode", ["min", "union"])
@pytest.mark.parametrize("seed,r,k,grid,thr", NMS_CASES)
def test_keep_mask_plain_matches_pallas_fixpoint(seed, r, k, grid, thr, mode):
    scores, boxes = random_rows(seed, r, k, grid)
    ref = np.asarray(
        pallas_nms_fixpoint_keep_mask(jnp.asarray(scores), jnp.asarray(boxes), thr, mode, interpret=True)
    )
    got = nms_fixpoint_keep_mask_plain(torch.as_tensor(scores), torch.as_tensor(boxes), thr, mode)
    np.testing.assert_array_equal(got.numpy(), ref)
    kernels.reset_launch_counts()
    via_wrapper = nms_fixpoint_keep_mask(torch.as_tensor(scores), torch.as_tensor(boxes), thr, mode)
    torch.testing.assert_close(via_wrapper, got, rtol=0, atol=0)
    assert nms_fixpoint_keep_mask.launches == 0  # a CPU tensor runs the plain version


def test_exact_threshold_rows_do_hit():
    """Pairs whose overlap equals the threshold exactly are suppressed
    (overlap >= t), in both modes."""
    boxes = np.array(
        [[[0.0, 0.0, 0.5, 0.5], [0.0, 0.25, 0.5, 0.75], [0.5, 0.5, 1.0, 1.0]]], np.float32
    )
    scores = np.array([[0.9, 0.8, 0.7]], np.float32)
    # second box: inter 0.125, min-area 0.25 (overlap 0.5), union 0.375 (1/3)
    for mode, thr in (("min", 0.5), ("union", 1.0 / 3.0)):
        got = nms_fixpoint_keep_mask_plain(torch.as_tensor(scores), torch.as_tensor(boxes), thr, mode)
        ref = np.asarray(
            pallas_nms_fixpoint_keep_mask(jnp.asarray(scores), jnp.asarray(boxes), thr, mode, interpret=True)
        )
        np.testing.assert_array_equal(got.numpy(), ref)
        if mode == "min":
            assert got.tolist() == [[True, False, True]]


@pytest.mark.parametrize("seed,r,k,grid,thr", NMS_CASES)
def test_nms_sorted_kernel_matches_nms_sorted_pallas(seed, r, k, grid, thr):
    scores, boxes = random_rows(seed, r, k, grid)
    keep_top_k = 16
    ref_s, ref_b = nms_sorted_pallas(
        jnp.asarray(scores), jnp.asarray(boxes), thr, keep_top_k, "min", interpret=True, method="fixpoint"
    )
    got_s, got_b = nms_sorted_kernel(torch.as_tensor(scores), torch.as_tensor(boxes), thr, keep_top_k, "min")
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(ref_s))
    np.testing.assert_array_equal(got_b.numpy(), np.asarray(ref_b))


@pytest.mark.parametrize("mode", ["min", "union"])
def test_suppression_matrix_matches_jax_overlap(mode):
    """Random (not grid) rows: no overlap sits at the threshold, so the
    division-free predicate and the JAX `overlap_matrix >= t` agree."""
    _, boxes = random_rows(5, 3, 50)
    thr = 0.45
    upper = np.triu(np.ones((50, 50), bool), 1)
    ref = np.stack([np.asarray(jax_nms.overlap_matrix(jnp.asarray(b), mode)) >= thr for b in boxes]) & upper
    np.testing.assert_array_equal(suppression_matrix(torch.as_tensor(boxes), thr, mode).numpy(), ref)


@pytest.mark.parametrize("fn", ["nms_sorted", "nms_sorted_fixpoint"])
@pytest.mark.parametrize("mode", ["min", "union"])
def test_ops_nms_matches_jax(fn, mode):
    """The port's NMS against the JAX package's `ops/nms.py` (sequential
    scan and suppression fixpoint, both dividing). Random (not grid) rows:
    the division cannot meet the threshold exactly, so the two predicates
    cannot disagree."""
    scores, boxes = random_rows(6, 8, 80)
    ref = jax.vmap(lambda s, b: getattr(jax_nms, fn)(s, b, 0.45, 20, mode))(jnp.asarray(scores), jnp.asarray(boxes))
    got = nms_sorted_kernel(torch.as_tensor(scores), torch.as_tensor(boxes), 0.45, 20, mode)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


def test_fixpoint_long_chain_matches_sequential():
    """A suppression chain as deep as the row: box i overlaps only i+1, so
    the fixpoint needs ~K steps and must still give the greedy keep set."""
    n = 48
    ys = 0.05 + 0.015 * np.arange(n)
    boxes = np.stack([ys, np.full(n, 0.1), ys + 0.03, np.full(n, 0.5)], -1)[None].astype(np.float32)
    scores = np.linspace(1.0, 0.5, n, dtype=np.float32)[None]
    s, b = torch.as_tensor(scores), torch.as_tensor(boxes)
    seq = jax_nms.nms_sorted(jnp.asarray(scores[0]), jnp.asarray(boxes[0]), 0.3, n, "min")
    ker = nms_sorted_kernel(s, b, 0.3, n, "min")
    for a, d in zip(seq, ker):
        np.testing.assert_array_equal(d[0].numpy(), np.asarray(a))
    assert int((ker[0] > 0).sum()) == n // 2  # every other box survives
    _, steps = fixpoint_keep(s > 0, suppression_matrix(b, 0.3, "min"))
    assert steps >= n // 2  # the chain settles one level per step


def test_nms_rejects_unknown_mode():
    scores, boxes = random_rows(7, 1, 8)
    with pytest.raises(ValueError):
        nms_fixpoint_keep_mask(torch.as_tensor(scores), torch.as_tensor(boxes), 0.5, "iou")
