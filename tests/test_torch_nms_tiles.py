"""A numpy model of the schedule of `nms_cluster_kernel` (`csrc/nms_greedy.cu`),
the wide-row NMS kernel for rows of MAX_K < K <= CLUSTER_MAX_K candidates,
held to the port's plain versions on the CPU. The kernel runs only on the
card (tests/test_torch_cuda.py, chip_smoke.py); this rehearses its logic.

The model works as the kernel does. A row is cut into tiles of T
candidates; tile t belongs to CTA t % C of the row's cluster and, in it, to
warp (t // C) % W, as that warp's tile u = t // (C W). In each step every
CTA resolves the greedy inside its first alive tile (capped: counting from
the boxes kept so far) and sends a note of it, with its next alive tile,
to every CTA. The notes' tiles are then taken in order while no other
alive tile lies before them (each earlier note's next alive tile bounds
them), their kept boxes fit a warp (32; the first note always), and no box
kept in an earlier taken tile suppresses one kept in a later one: their
kept sets are then the sequential sweep's. Capped, the taken boxes stop
at keep_top_k. Every alive candidate of a tile after the last taken one is
tested against the taken boxes; each warp finds those tiles by the
kernel's own index arithmetic. K-A's predicate is division-free, K-C's is
decided by the kernel's `scan_verdict` and divided only near the
threshold.
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from ron_tensorflow_tpu_torch.kernels import nms_fixpoint_keep_mask_plain, nms_scan_keep_mask_plain

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_nms_sweep import (  # noqa: E402
    disjoint_rows,
    identical_rows,
    nan_first_rows,
    random_rows,
    scan_verdict,
    suppresses,
)

T, C = 32, 4  # the kernel's tile; a cluster of 4 CTAs
KERNEL_WARPS = 32


@pytest.fixture(autouse=True, scope="module")
def two_torch_threads():
    """The plain versions' small tensor ops gain nothing from more threads;
    the run shares its cores with the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def verdict(box_i, boxes_j, thr, mode, divide):
    """The kernel's `suppresses`: K-A's predicate, or K-C's through
    `scan_verdict` (divided only near the threshold)."""
    if not divide:
        return suppresses(box_i, boxes_j, thr, mode, divide=False)
    vol_i = (box_i[2] - box_i[0]) * (box_i[3] - box_i[1])
    vol_j = (boxes_j[:, 2] - boxes_j[:, 0]) * (boxes_j[:, 3] - boxes_j[:, 1])
    ih = np.maximum(np.minimum(box_i[2], boxes_j[:, 2]) - np.maximum(box_i[0], boxes_j[:, 0]), np.float32(0))
    iw = np.maximum(np.minimum(box_i[3], boxes_j[:, 3]) - np.maximum(box_i[1], boxes_j[:, 1]), np.float32(0))
    inter = ih * iw
    denom = (vol_i + vol_j) - inter if mode == "union" else np.minimum(vol_i, vol_j)
    return scan_verdict(inter, denom, thr)[0]


def tile_sweep_row(scores, boxes, thr, mode, divide, cap=None, tile=T, ctas=C, warps=KERNEL_WARPS):
    """One row's keep mask by the cluster kernel's schedule; also returns
    the number of steps taken."""
    k = scores.shape[0]
    j = np.arange(k)
    t_of = j // tile
    u_of = t_of // (ctas * warps)
    first_of = t_of % ctas + ctas * (t_of // ctas % warps)  # each candidate's warp's tile u = 0
    alive = scores > 0  # NaN is not
    keep = np.zeros(k, bool)
    kept, steps = 0, 0

    def resolve(t):
        """The greedy inside tile t from the alive flags, counting from `kept`."""
        a = np.flatnonzero(alive[t * tile:(t + 1) * tile]) + t * tile
        out = []
        while a.size and (cap is None or kept + len(out) < cap):
            i, a = a[0], a[1:]
            out.append(i)
            a = a[~verdict(boxes[i], boxes[a], thr, mode, divide)]
        return out

    while cap is None or kept < cap:
        # each warp's first and next alive tile, each CTA's first and next
        warp_tiles = {}
        for t in np.unique(t_of[alive]):
            warp_tiles.setdefault((t % ctas, t // ctas % warps), []).append(t)
        notes = []
        for c in range(ctas):
            mine = [ts for (cc, _), ts in warp_tiles.items() if cc == c]
            if not mine:
                continue
            first = min(ts[0] for ts in mine)
            nxt = min([ts[1] for ts in mine if ts[0] == first and len(ts) > 1] + [ts[0] for ts in mine if ts[0] != first],
                      default=None)
            assert sorted(t for ts in mine for t in ts)[:2] == [first] + ([nxt] if nxt is not None else [])
            notes.append((first, nxt, resolve(first)))
        if not notes:
            break
        notes.sort()
        assert not alive[: notes[0][0] * tile].any()
        # take the notes' tiles in order while nothing could change their kept sets
        taken, bound = [], None
        for first, nxt, kp in notes:
            if bound is not None and first >= bound:
                break
            if taken and sum(len(n[2]) for n in taken) + len(kp) > tile:
                break
            earlier = [i for n in taken for i in n[2]]
            if any(verdict(boxes[i], boxes[np.array(kp)], thr, mode, divide).any() for i in earlier):
                break
            taken.append((first, nxt, kp))
            bound = nxt if bound is None else min(bound, nxt if nxt is not None else bound)
        boxes_taken = [i for n in taken for i in n[2]]
        if cap is not None:
            boxes_taken = boxes_taken[:cap - kept]
        assert boxes_taken
        keep[boxes_taken] = True
        kept += len(boxes_taken)
        steps += 1
        for first, _, _ in taken:
            alive[first * tile:(first + 1) * tile] = False
        if cap is not None and kept >= cap:
            break
        # each warp's tiles from `after` on: exactly the tiles after the last taken one
        last = boxes_taken[-1] // tile
        last_first, last_u = last % ctas + ctas * (last // ctas % warps), last // (ctas * warps)
        after = last_u + (first_of <= last_first)
        later = u_of >= after
        assert np.array_equal(later, t_of > last)
        for i in boxes_taken:
            cand = np.flatnonzero(alive & later)
            alive[cand[verdict(boxes[i], boxes[cand], thr, mode, divide)]] = False
    return keep, steps


def tile_sweep(scores, boxes, thr, mode, divide, cap=None, **layout):
    rows = [tile_sweep_row(s, b, thr, mode, divide, cap, **layout) for s, b in zip(scores, boxes)]
    return np.stack([r[0] for r in rows]), [r[1] for r in rows]


def borderline_rows(r, k):
    """Box 0 against boxes shifted by float32 ulps so that their overlap
    with it lies within a few ulps of 0.4 (tests/test_torch_cuda.py's
    'borderline' edge rows)."""
    j = np.arange(k)
    x = np.where(j % 2 == 0, np.float32(0.6), np.float32(3 / 7)) + ((j // 2 - k // 4) * 2.0**-24).astype(np.float32)
    x[0] = 0.0
    boxes = np.stack([np.full(k, 0.2), x, np.full(k, 0.7), x + np.float32(1)], -1).astype(np.float32)
    return np.tile(np.linspace(1.0, 0.01, k, dtype=np.float32), (r, 1)), np.tile(boxes, (r, 1, 1))


def chain_rows(r, k):
    """At every multiple b of 32 with b + 1 < K: box A at b - 1 (the last
    slot of a tile), B at b (the first slot of the next) and C at b + 1 in
    one grid cell, A over B and B over C at 0.4 in both modes but A not
    over C; every other box alone in its cell. A suppresses B, so C is kept
    though B would suppress it: every candidate but the B's is kept."""
    side = int(np.ceil(np.sqrt(k)))
    cell = np.arange(k)
    shift = np.zeros(k)
    b = np.arange(32, k - 1, 32)
    cell[b] = cell[b + 1] = b - 1
    shift[b], shift[b + 1] = 0.3, 0.65
    w = 0.3 / side
    y0, x0 = (cell // side) / side, (cell % side) / side + shift * w
    boxes = np.stack([y0, x0, y0 + 0.5 / side, x0 + w], -1).astype(np.float32)
    want = np.ones(k, bool)
    want[b] = False
    return (np.tile(np.linspace(1.0, 0.01, k, dtype=np.float32), (r, 1)), np.tile(boxes, (r, 1, 1)),
            np.tile(want, (r, 1)))


def capped(keep, cap):
    """The first `cap` kept of each row."""
    return keep & (np.cumsum(keep, -1) <= cap)


def plain(scores, boxes, thr, mode, cap=None):
    s, b = torch.as_tensor(scores), torch.as_tensor(boxes)
    if cap is None:
        return nms_fixpoint_keep_mask_plain(s, b, thr, mode).numpy()
    return nms_scan_keep_mask_plain(s, b, thr, cap, mode).numpy()


def tiles_holding_a_kept_box(keep, tile=T):
    return [len(np.unique(np.flatnonzero(row) // tile)) for row in keep]


def assert_steps(steps, keep, tile=T, ctas=C):
    """A step takes at least one and at most C of the tiles that hold a
    kept box."""
    for n, held in zip(steps, tiles_holding_a_kept_box(keep, tile)):
        assert -(-held // ctas) <= n <= held


ROWS = {
    "random": lambda k: random_rows(k, 2, k),
    "random on a 1/8 grid": lambda k: random_rows(k + 1, 2, k, grid=8),
    "nan first": lambda k: nan_first_rows(k + 2, 2, k),
    "disjoint": lambda k: disjoint_rows(1, k),
    "identical": lambda k: identical_rows(1, k),
    "borderline": lambda k: borderline_rows(1, k),
    "chain": lambda k: chain_rows(1, k)[:2],
}
CAPS = (1, 7, 33)  # keep_top_k: the cap falls inside a tile's greedy or a few tiles on; K too


@pytest.mark.parametrize("mode", ["min", "union"])
@pytest.mark.parametrize("k,warps", [(300, 2), (600, 2), (600, KERNEL_WARPS)])
@pytest.mark.parametrize("rows", list(ROWS))
def test_tile_sweep_equals_plain(rows, k, warps, mode):
    """K-A's schedule against the fixpoint, K-C's at caps 1, 7, 33 and K
    against the scan, T = 32 and C = 4, with 2 warps a CTA (several tiles
    a warp) and the kernel's 32."""
    scores, boxes = ROWS[rows](k)
    thr = 0.5 if rows == "random on a 1/8 grid" else 0.4
    fix, steps = tile_sweep(scores, boxes, thr, mode, divide=False, warps=warps)
    np.testing.assert_array_equal(fix, plain(scores, boxes, thr, mode))
    assert_steps(steps, fix)
    scan_all = plain(scores, boxes, thr, mode, cap=k)
    for cap in CAPS + (k,):
        got, steps = tile_sweep(scores, boxes, thr, mode, divide=True, cap=cap, warps=warps)
        np.testing.assert_array_equal(got, capped(scan_all, cap), err_msg=f"keep_top_k {cap}")
        assert_steps(steps, got)
    kept = {"disjoint": k, "identical": 1}.get(rows)
    if kept is not None:
        assert fix.sum(-1).tolist() == [kept]
    if rows == "chain":
        np.testing.assert_array_equal(fix, chain_rows(1, k)[2])


@pytest.mark.parametrize("mode", ["min", "union"])
def test_capped_plain_is_the_first_kept_of_the_uncapped_scan(mode):
    """K-C's plain version at keep_top_k c keeps the first c of what it keeps
    at keep_top_k K (a taken candidate's kills do not depend on the cap):
    the card tests and chip_smoke.py check each cap's mask against this
    prefix of one plain call."""
    k = 455
    scores, boxes = random_rows(3, 3, k)
    scan_all = plain(scores, boxes, 0.4, mode, cap=k)
    assert int(scan_all.sum(-1).min()) > 7
    for cap in (0,) + CAPS + (20, 200):
        np.testing.assert_array_equal(plain(scores, boxes, 0.4, mode, cap=cap), capped(scan_all, cap))


@pytest.mark.parametrize("tile,ctas", [(64, 4), (128, 2), (32, 16)])
def test_tile_sweep_at_other_tiles_and_clusters(tile, ctas):
    """The schedule is exact at any T and C: tiles of 64 and 128, a cluster
    of 2 and of 16, both predicates, on random rows."""
    k = 600
    scores, boxes = random_rows(21, 2, k)
    fix, steps = tile_sweep(scores, boxes, 0.4, "union", divide=False, tile=tile, ctas=ctas)
    np.testing.assert_array_equal(fix, plain(scores, boxes, 0.4, "union"))
    assert_steps(steps, fix, tile, ctas)
    got, _ = tile_sweep(scores, boxes, 0.4, "min", divide=True, cap=33, tile=tile, ctas=ctas)
    np.testing.assert_array_equal(got, plain(scores, boxes, 0.4, "min", cap=33))


def test_steps_take_tiles_not_kept_boxes():
    """A disjoint row keeps all K in ceil(K / T) steps (a full tile's 32
    boxes fill a step); an identical row keeps one in one step; random
    'union' rows take several tiles a step."""
    k = 455
    keep, steps = tile_sweep(*disjoint_rows(1, k), 0.4, "min", divide=False)
    assert keep.all() and steps == [-(-k // T)]
    keep, steps = tile_sweep(*identical_rows(1, k), 0.4, "union", divide=True, cap=k)
    assert keep.sum() == 1 and steps == [1]
    keep, steps = tile_sweep(*random_rows(5, 1, 600), 0.4, "union", divide=False)
    assert steps[0] < tiles_holding_a_kept_box(keep)[0]
