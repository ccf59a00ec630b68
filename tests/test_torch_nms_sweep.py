"""A numpy model of the greedy sweep that `csrc/nms_greedy.cu` runs for both
NMS keep masks (K-A uncapped and division-free, K-C capped and dividing),
held to the JAX package's Pallas kernels in interpret mode and, at K = 2048,
to the port's plain versions. It rehearses on the CPU the logic of the CUDA
kernel, which runs only on the card (tests/test_torch_cuda.py, chip_smoke.py).

The model works as the kernel does: a row's alive flags are bits of 32-bit
words, set where score > 0; each step takes the lowest set bit i (the first
non-empty word, then its lowest bit), clears it, and evaluates i's predicate
only against the candidates whose bits are still set, all of them after i;
the hits' bits are cleared. It stops when no bit is left or, capped, when
keep_top_k candidates are kept. Every product, sum and difference is one
float32 operation, as in the kernel. Beside it, the kernel's way of deciding
the dividing predicate without the division where the answer is certain
(`scan_verdict` in the source), held to the division on pairs crowded
around the threshold.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ron_tensorflow_tpu.kernels.nms_pallas import pallas_nms_fixpoint_keep_mask, pallas_nms_keep_mask

from ron_tensorflow_tpu_torch.kernels import nms_fixpoint_keep_mask_plain, nms_scan_keep_mask_plain


def suppresses(box_i, boxes_j, threshold, mode, divide):
    """Does taken box_i [4] suppress each of boxes_j [n, 4]? float32
    throughout: the kernel's predicates, dividing (K-C) or not (K-A)."""
    f32 = np.float32
    t = f32(threshold)
    vol_i = (box_i[2] - box_i[0]) * (box_i[3] - box_i[1])
    vol_j = (boxes_j[:, 2] - boxes_j[:, 0]) * (boxes_j[:, 3] - boxes_j[:, 1])
    ih = np.maximum(np.minimum(box_i[2], boxes_j[:, 2]) - np.maximum(box_i[0], boxes_j[:, 0]), f32(0))
    iw = np.maximum(np.minimum(box_i[3], boxes_j[:, 3]) - np.maximum(box_i[1], boxes_j[:, 1]), f32(0))
    inter = ih * iw
    denom = (vol_i + vol_j) - inter if mode == "union" else np.minimum(vol_i, vol_j)
    pos = denom > 0
    if divide:
        ov = np.where(pos, inter / np.where(pos, denom, f32(1)), f32(0))
        return ov >= t
    return (inter >= t * denom) & pos


def set_bits(words):
    """Candidate indices of the set bits of uint32 words, ascending."""
    return np.flatnonzero(np.unpackbits(words.view(np.uint8), bitorder="little"))


def sweep_row(scores, boxes, threshold, mode, divide, cap=None):
    """One row's keep mask by the word-level greedy sweep; also returns the
    number of predicate evaluations it made."""
    k = scores.shape[0]
    words = np.zeros((k + 31) // 32, np.uint32)
    valid = np.flatnonzero(scores > 0)  # NaN is not > 0
    np.bitwise_or.at(words, valid // 32, (np.uint32(1) << (valid % 32).astype(np.uint32)))
    keep = np.zeros(k, bool)
    evaluations = 0
    while cap is None or keep.sum() < cap:
        live = np.flatnonzero(words)
        if live.size == 0:
            break
        w = live[0]
        word = int(words[w])
        i = 32 * w + (word & -word).bit_length() - 1  # lowest set bit
        words[w] &= np.uint32(~(1 << (i % 32)) & 0xFFFFFFFF)
        keep[i] = True
        j = 32 * w + set_bits(words[w:])  # the alive candidates, all after i
        assert (j > i).all()
        evaluations += j.size
        hit = j[suppresses(boxes[i], boxes[j], threshold, mode, divide)]
        np.bitwise_and.at(words, hit // 32, ~(np.uint32(1) << (hit % 32).astype(np.uint32)))
    return keep, evaluations


def sweep(scores, boxes, threshold, mode, divide, cap=None):
    return np.stack([sweep_row(s, b, threshold, mode, divide, cap)[0] for s, b in zip(scores, boxes)])


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


def disjoint_rows(r, k):
    """Boxes on a grid of disjoint cells, all scores > 0: nothing suppresses
    anything, so all K are kept, the sweep's longest chain of steps."""
    side = int(np.ceil(np.sqrt(k)))
    cell = np.arange(k)
    y0, x0 = (cell // side) / side, (cell % side) / side
    boxes = np.stack([y0, x0, y0 + 0.5 / side, x0 + 0.5 / side], -1).astype(np.float32)
    scores = np.linspace(1.0, 0.01, k, dtype=np.float32)
    return np.tile(scores, (r, 1)), np.tile(boxes, (r, 1, 1))


def identical_rows(r, k):
    """One box K times, all scores > 0: the first suppresses the rest."""
    scores = np.linspace(1.0, 0.01, k, dtype=np.float32)
    boxes = np.tile(np.array([0.2, 0.3, 0.6, 0.5], np.float32), (r, k, 1))
    return np.tile(scores, (r, 1)), boxes


def nan_first_rows(seed, r, k):
    """Random rows whose first score is NaN, as a descending torch.sort puts
    it: the valid candidates are not a prefix."""
    scores, boxes = random_rows(seed, r, k)
    scores[:, 0] = np.nan
    return scores, boxes


def pallas_fixpoint(scores, boxes, thr, mode):
    return np.asarray(pallas_nms_fixpoint_keep_mask(jnp.asarray(scores), jnp.asarray(boxes), thr, mode,
                                                    interpret=True))


def pallas_scan(scores, boxes, thr, cap, mode):
    return np.asarray(pallas_nms_keep_mask(jnp.asarray(scores), jnp.asarray(boxes), thr, cap, mode,
                                           interpret=True))


# (seed, rows, K, grid, threshold): tests/test_torch_kernels.py's NMS_CASES
NMS_CASES = [
    (0, 6, 64, None, 0.45),
    (1, 40, 200, None, 0.4),  # the main path's K and threshold
    (2, 16, 96, 8, 0.5),  # exact-threshold hits on a 1/8 grid
    (3, 16, 96, 4, 0.25),
]
# (seed, rows, K, grid, threshold, keep_top_k): tests/test_torch_nms_scan.py's SCAN_CASES
SCAN_CASES = [
    (0, 13, 200, None, 0.4, 100),
    (1, 5, 31, None, 0.45, 200),  # keep_top_k above K
    (2, 16, 96, 8, 0.5, 200),
    (3, 16, 96, 4, 0.25, 200),
    (4, 8, 200, None, 0.7, 16),  # a cap that binds: 16 of 200
]


@pytest.mark.parametrize("mode", ["min", "union"])
@pytest.mark.parametrize("seed,r,k,grid,thr", NMS_CASES)
def test_uncapped_sweep_matches_pallas_fixpoint(seed, r, k, grid, thr, mode):
    scores, boxes = random_rows(seed, r, k, grid)
    np.testing.assert_array_equal(sweep(scores, boxes, thr, mode, divide=False),
                                  pallas_fixpoint(scores, boxes, thr, mode))


@pytest.mark.parametrize("mode", ["min", "union"])
@pytest.mark.parametrize("seed,r,k,grid,thr,cap", SCAN_CASES)
def test_capped_sweep_matches_pallas_scan(seed, r, k, grid, thr, cap, mode):
    scores, boxes = random_rows(seed, r, k, grid)
    got = sweep(scores, boxes, thr, mode, divide=True, cap=min(cap, k))
    np.testing.assert_array_equal(got, pallas_scan(scores, boxes, thr, cap, mode))


EDGE_ROWS = {
    "nan first": lambda k: nan_first_rows(7, 3, k),
    "disjoint": lambda k: disjoint_rows(2, k),
    "identical": lambda k: identical_rows(2, k),
}
EDGE_KEPT = {"disjoint": lambda k: k, "identical": lambda k: 1}


@pytest.mark.parametrize("mode", ["min", "union"])
@pytest.mark.parametrize("edge", list(EDGE_ROWS))
def test_sweep_edge_rows_match_pallas(edge, mode):
    """Both predicates, uncapped against the fixpoint kernel and capped
    (keep_top_k 100 and 0) against the scan kernel."""
    k = 200
    scores, boxes = EDGE_ROWS[edge](k)
    uncapped = sweep(scores, boxes, 0.4, mode, divide=False)
    np.testing.assert_array_equal(uncapped, pallas_fixpoint(scores, boxes, 0.4, mode))
    for cap in (100, 0):
        capped = sweep(scores, boxes, 0.4, mode, divide=True, cap=cap)
        np.testing.assert_array_equal(capped, pallas_scan(scores, boxes, 0.4, cap, mode))
    if edge in EDGE_KEPT:
        assert uncapped.sum(-1).tolist() == [EDGE_KEPT[edge](k)] * len(scores)
    if edge == "nan first":
        assert not uncapped[:, 0].any()


def test_sweep_evaluates_only_taken_against_alive():
    """The work is the kept candidates' passes over what is still alive: on
    a row of identical boxes one pass over the K - 1 others, and on a row
    of disjoint boxes K - 1 - i evaluations by the i-th kept."""
    k = 200
    s, b = identical_rows(1, k)
    keep, evaluations = sweep_row(s[0], b[0], 0.4, "min", divide=False)
    assert keep.sum() == 1 and evaluations == k - 1
    s, b = disjoint_rows(1, k)
    keep, evaluations = sweep_row(s[0], b[0], 0.4, "min", divide=True)
    assert keep.all() and evaluations == k * (k - 1) // 2


@pytest.mark.parametrize("mode", ["min", "union"])
def test_sweep_at_k_2048_matches_plain_and_pallas_scan(mode):
    """Past the old 1024 limit: the plain versions (no K limit) and the
    Pallas scan kernel; rows random, on a 1/8 grid, and NaN-first."""
    k, thr = 2048, 0.5
    rows = [random_rows(8, 1, k), random_rows(9, 1, k, grid=8), nan_first_rows(10, 1, k)]
    scores, boxes = np.concatenate([r[0] for r in rows]), np.concatenate([r[1] for r in rows])
    s, b = torch.as_tensor(scores), torch.as_tensor(boxes)
    np.testing.assert_array_equal(sweep(scores, boxes, thr, mode, divide=False),
                                  nms_fixpoint_keep_mask_plain(s, b, thr, mode).numpy())
    np.testing.assert_array_equal(sweep(scores, boxes, thr, mode, divide=True, cap=100),
                                  nms_scan_keep_mask_plain(s, b, thr, 100, mode).numpy())
    np.testing.assert_array_equal(sweep(scores, boxes, thr, mode, divide=True, cap=k),
                                  pallas_scan(scores, boxes, thr, k, mode))


def scan_verdict(inter, denom, t):
    """The CUDA kernel's verdict on K-C's predicate, ov = RN(inter / denom)
    if denom > 0 and inter != 0 else 0; ov >= t, element-wise over float32
    arrays: with P = RN(t * denom), inter at least 4 ulps above P is a hit
    and at least 4 ulps below P a miss; the rest is divided."""
    f32, u32 = np.float32, np.uint32
    t = f32(t)
    t_normal = bool(np.finfo(f32).tiny <= t <= np.finfo(f32).max)
    with np.errstate(all="ignore"):
        zero = ~(denom > 0) | (inter == 0)
        pb = (t * denom).astype(f32).view(u32)
        in_range = t_normal & ((pb - u32(4)) <= u32(0x7F7FFFFB - 4))
        above = inter >= (pb + u32(4)).view(f32)
        below = inter <= (pb - u32(4)).view(f32)
        border = ~zero & ~(in_range & (above | below))
        hit = np.where(zero, f32(0) >= t, in_range & above)
        divided = (inter / np.where(border, denom, f32(1))).astype(f32) >= t
    return np.where(border, divided, hit), border


@pytest.mark.parametrize("t", [0.4, 0.5, 0.45, 1 / 3, 0.25, 0.7, 1.0, 1e-3, 2.0**-126, 1e-40, 0.0, -0.5,
                               np.inf, np.nan, 3.0, 1e30])
def test_scan_verdict_without_division_equals_the_division(t):
    """Pairs crowded within 16 ulps of inter = t * denom, over denominators
    from denormal to 1e38, zero, negative and NaN numerators and
    denominators: the kernel's verdict equals the IEEE division's."""
    rng = np.random.default_rng(11)
    f32, n = np.float32, 40000
    t = f32(t)
    denom = np.concatenate([rng.uniform(0, 1, n), 10.0 ** rng.uniform(-44, 38, n), [0.0, -0.1, np.nan]]).astype(f32)
    with np.errstate(all="ignore"):
        base = (t * denom).astype(f32)
    base = np.where(np.isfinite(base), base, f32(1))
    near = (base.view(np.uint32).astype(np.int64) + rng.integers(-16, 17, base.size)) & 0xFFFFFFFF
    inter = np.where(rng.random(base.size) < 0.25, rng.uniform(0, 1, base.size).astype(f32) * denom,
                     near.astype(np.uint32).view(f32)).astype(f32)
    inter[rng.random(base.size) < 0.01] = np.nan
    inter[rng.random(base.size) < 0.01] = 0.0
    got, border = scan_verdict(inter, denom, t)
    with np.errstate(all="ignore"):
        ov = np.where((denom > 0) & (inter != 0), (inter / np.where(denom > 0, denom, f32(1))).astype(f32), f32(0))
    np.testing.assert_array_equal(got, ov >= t)
    if t in (f32(0.4), f32(0.5)):
        assert 0 < border.mean() < 0.5  # some pairs are divided, most are not
