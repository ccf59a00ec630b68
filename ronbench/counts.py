"""The yardstick's arithmetic: the card's peaks and the kernels' bounds.

Frozen copies of `chip_smoke.py`'s `bound`, `block_cost` and `sweep_pairs`
(the port's gate script), so that a later change to the program cannot
move the yardstick. Peaks: one NVIDIA H100 SXM at its 700 W limit (NVIDIA's
data sheet, dense): 989 TFLOP/s bf16 on the tensor cores, 67 TFLOP/s f32
outside them, 3.35 TB/s of HBM3. A share of a peak is stated against these,
with the card's power limit beside it.
"""

from __future__ import annotations

import torch

PEAK_BYTES_PER_S = 3.35e12
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
NMS_BYTES_PER_CANDIDATE = 4 + 16 + 1  # its score and box read, its keep flag written
NMS_OPS_PER_PAIR = 12  # one overlap test: intersection, denominator, comparison


def bound(nbytes, flops, peak_flops):
    """(least ms, 'bytes' or 'operations'): the larger of the bytes over the
    HBM rate and the operations over the peak."""
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, flops / peak_flops
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def block_cost(batch, height, width, cin, c):
    """(operations, bytes) of K-B, fused VGG block 1 (conv1_1, conv1_2, ReLUs
    and the 2x2 pool) on x [B, H, W, Ci] -> [B, H/2, W/2, C]: both convs'
    multiply-adds; x read and the bf16 output written once, the bf16 weights
    and f32 biases read once."""
    flops = 2 * batch * height * width * c * 9 * (cin + c)
    nbytes = (batch * height * width * cin * 2 + batch * (height // 2) * (width // 2) * c * 2
              + (c * cin * 9 + c * c * 9) * 2 + 2 * c * 4)
    return flops, nbytes


def nms_bound_ms(rows: int, k: int, pairs: int) -> float:
    """Least ms of one keep-mask launch over [rows, k] that tests `pairs` overlaps."""
    return bound(rows * k * NMS_BYTES_PER_CANDIDATE, NMS_OPS_PER_PAIR * pairs, PEAK_F32_FLOPS)[0]


def sweep_pairs(scores, boxes, thr, mode, keep, dividing=False):
    """Overlaps the greedy sweep that gives `keep` must evaluate: each kept
    i against every later candidate still alive at i's turn, that is with a
    score > 0 and not suppressed by a kept box before i. A candidate j is
    tested by the kept boxes before it up to and including the first that
    suppresses it. The predicate is the division-free one, or the dividing
    one where `dividing`."""
    total, k = 0, keep.shape[-1]
    arange, chunk = torch.arange(k, device=keep.device), max(1, (1 << 24) // k)  # kept boxes tested at once
    for r in range(keep.shape[0]):
        idx = keep[r].nonzero().squeeze(1)
        n = idx.numel()
        first = torch.full_like(arange, n)  # index in kept order of j's first suppressor, n if none
        y0, x0, y1, x1 = boxes[r].unbind(-1)
        vol = (y1 - y0) * (x1 - x0)
        for c0 in range(0, n, chunk):
            i = idx[c0:c0 + chunk, None]
            ih = torch.clamp(torch.minimum(y1, y1[i]) - torch.maximum(y0, y0[i]), min=0.0)
            iw = torch.clamp(torch.minimum(x1, x1[i]) - torch.maximum(x0, x0[i]), min=0.0)
            inter = ih * iw
            denom = (vol + vol[i]) - inter if mode == "union" else torch.minimum(vol, vol[i])
            if dividing:
                hit = torch.where(denom > 0.0, inter / torch.where(denom > 0.0, denom, 1.0), 0.0) >= thr
            else:
                hit = (inter >= thr * denom) & (denom > 0.0)
            hit &= i < arange
            found = hit.any(0)
            first = torch.where((first == n) & found, hit.to(torch.uint8).argmax(0) + c0, first)
        before = torch.cumsum(keep[r], 0) - keep[r].long()  # kept boxes ahead of j
        total += int((torch.minimum(before, first + 1) * (scores[r] > 0.0)).sum())
    return total
