"""The yardstick's arithmetic against counts made by hand."""

import json
from pathlib import Path

import pytest
import torch

from ronbench import counts
from ronbench.reference import nets, postprocess

CONFIGS = Path(__file__).resolve().parents[1] / "configs"


def test_block1_flops_at_320_against_a_hand_count():
    hand = 2 * 320 * 320 * 64 * (3 * 9) + 2 * 320 * 320 * 64 * (64 * 9)  # conv1_1 then conv1_2, per image
    assert counts.block_cost(32, 320, 320, 3, 64)[0] == 32 * hand
    net = nets.Net(nets.Params())
    x = net.conv("conv1_1", torch.empty((0, 3, 320, 320)), 64)
    net.conv("conv1_2", x, 64)
    assert net.flops == hand


def test_block1_bytes():
    _, nbytes = counts.block_cost(32, 320, 320, 3, 64)
    assert nbytes == 32 * 320 * 320 * 3 * 2 + 32 * 160 * 160 * 64 * 2 + (64 * 3 * 9 + 64 * 64 * 9) * 2 + 2 * 64 * 4


@pytest.mark.parametrize("name, gflops", [("ron320", 138.2572032), ("ssd300", 62.747075584)])
def test_forward_flops_of_each_configuration(name, gflops):
    cfg = json.loads((CONFIGS / f"{name}.json").read_text())
    assert nets.flops_per_image(cfg) == pytest.approx(gflops * 1e9, rel=1e-12)


def rows(seed, r, k, grid=None):
    g = torch.Generator().manual_seed(seed)
    scores = torch.sort(torch.rand(r, k, generator=g), descending=True).values
    scores[:, k - k // 5:] = 0.0  # some padding
    cy, cx = (torch.rand(2, r, k, generator=g) * 0.6 + 0.2).unbind(0)
    h, w = (torch.rand(2, r, k, generator=g) * 0.35 + 0.05).unbind(0)
    boxes = torch.stack([cy - h / 2, cx - w / 2, cy + h / 2, cx + w / 2], -1)
    if grid:
        boxes = torch.round(boxes * grid) / grid
    return scores, boxes


def overlap_hit(a, b, thr, mode, divide):
    ih = max(min(a[2], b[2]) - max(a[0], b[0]), 0.0)
    iw = max(min(a[3], b[3]) - max(a[1], b[1]), 0.0)
    inter = ih * iw
    va, vb = (a[2] - a[0]) * (a[3] - a[1]), (b[2] - b[0]) * (b[3] - b[1])
    denom = va + vb - inter if mode == "union" else min(va, vb)
    if denom <= 0:
        return False
    return inter / denom >= thr if divide else inter >= thr * denom


def brute_sweep(scores, boxes, thr, mode, divide, cap=0):
    """A candidate at a time: (keep, overlaps tested)."""
    keep, tested = [], 0
    b = boxes.double().tolist()
    for row_s, row_b in zip(scores.tolist(), b):
        kept, row_keep = [], []
        for j, s in enumerate(row_s):
            alive = s > 0
            if alive:
                for i in kept:
                    tested += 1
                    if overlap_hit(row_b[i], row_b[j], thr, mode, divide):
                        alive = False
                        break
            take = alive and (not cap or len(kept) < cap)
            row_keep.append(take)
            if take:
                kept.append(j)
        keep.append(row_keep)
    return torch.tensor(keep), tested


@pytest.mark.parametrize("seed, mode, divide, grid", [(0, "min", False, None), (1, "union", True, None),
                                                      (2, "union", False, 8), (3, "min", True, 8)])
def test_greedy_keep_and_sweep_pairs_against_a_brute_force_sweep(seed, mode, divide, grid):
    scores, boxes = rows(seed, 6, 40, grid)
    thr = 0.5 if grid else 0.4
    want_keep, want_pairs = brute_sweep(scores, boxes, thr, mode, divide)
    keep = postprocess.greedy_keep(scores > 0, boxes, thr, mode, "divide" if divide else "multiply")
    assert torch.equal(keep, want_keep)
    assert counts.sweep_pairs(scores, boxes, thr, mode, keep, dividing=divide) == want_pairs


def test_capped_keep_is_the_uncapped_one_cut():
    scores, boxes = rows(4, 5, 40)
    capped = postprocess.greedy_keep(scores > 0, boxes, 0.4, "union", "divide", cap=3)
    want, _ = brute_sweep(scores, boxes, 0.4, "union", True, cap=3)
    assert torch.equal(capped, want)
    assert int(capped.sum(-1).max()) <= 3


def test_nms_bound_is_the_byte_bound_without_overlaps():
    assert counts.nms_bound_ms(640, 200, 0) == pytest.approx(640 * 200 * 21 / 3.35e12 * 1e3)
    assert counts.bound(0, 67e12, counts.PEAK_F32_FLOPS) == (1e3, "operations")
