"""The comparison that decides `correct`, and the control's lower precision.

Two numbers, each with a limit from the cell's configuration or traffic
file (`limits`):

- `heads_rel_err`: the program's head outputs of the sampled calls (class
  logits, objectness logits, box offsets) against the reference's forward
  on the same images and weights in float32: for each image and output,
  the L2 norm of the difference over the L2 norm of the reference's; the
  largest over images and outputs.
- `det_mismatch` (detection head) and `rt_mismatch` (realtime head): the
  program's detections of the sampled calls against the reference's
  postprocess run on the program's own head outputs (so the two meet the
  same decisions): the share of detections, the program's and the
  reference's together, that find no partner in the same row with the
  same label, the same score (within 1e-6) and the same box (within 1e-5).

The control puts the reference in the program's place one precision step
down: the forward's convolutions in float8 (e4m3, one scale a tensor, for
the bfloat16 model) and the postprocess in bfloat16 (for its float32).
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

SCORE_TOL = 1e-6
BOX_TOL = 1e-5
HEAD_KEYS = ("logits", "objness_logits", "locations")


def rel_err(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor]) -> float:
    """Largest per-image relative L2 error over the head outputs."""
    worst = 0.0
    for key in HEAD_KEYS:
        p, r = prog[key].double(), ref[key].double()
        diff = (p - r).flatten(1).norm(dim=1)
        base = r.flatten(1).norm(dim=1)
        worst = max(worst, float(torch.where(base > 0, diff / base.clamp(min=1e-300), diff).max()))
    return worst


def unmatched(a_scores, a_boxes, a_labels, a_valid, b_scores, b_boxes, b_labels, b_valid) -> Tuple[int, int]:
    """(entries of a with no partner in b, entries of a) over rows [R, K]."""
    same = ((a_scores[:, :, None] - b_scores[:, None, :]).abs() <= SCORE_TOL)
    same &= (a_boxes[:, :, None, :] - b_boxes[:, None, :, :]).abs().amax(-1) <= BOX_TOL
    same &= a_labels[:, :, None] == b_labels[:, None, :]
    same &= b_valid[:, None, :]
    lone = a_valid & ~same.any(-1)
    return int(lone.sum()), int(a_valid.sum())


def mismatch(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor]) -> Tuple[int, int]:
    """(detections without a partner, detections) of the program's and the
    reference's rows together. Rows: [..., K] scores, [..., K, 4] boxes;
    `labels` and `valid` where the head gives them (else the row's label
    and score > 0)."""
    def rows(d):
        s = d["scores"].float()
        k = s.shape[-1]
        s = s.reshape(-1, k)
        b = d["boxes"].float().reshape(-1, k, 4)
        lab = d["labels"].reshape(-1, k) if "labels" in d else torch.zeros_like(s, dtype=torch.long)
        v = d["valid"].reshape(-1, k).bool() if "valid" in d else s > 0
        return s, b, lab.long(), v

    p, r = rows(prog), rows(ref)
    lone_p, n_p = unmatched(*p, *r)
    lone_r, n_r = unmatched(*r, *p)
    return lone_p + lone_r, n_p + n_r


def fp8(t: torch.Tensor) -> torch.Tensor:
    """t rounded to float8 e4m3 with one scale for the tensor (its largest
    magnitude at 448, the format's largest), back in t's dtype."""
    scale = t.abs().amax().clamp(min=1e-30) / 448.0
    return ((t / scale).to(torch.float8_e4m3fn).to(t.dtype)) * scale


def fp8_ste(t: torch.Tensor) -> torch.Tensor:
    """`fp8` in the forward; the gradient passes as if unrounded (straight through)."""
    return t + (fp8(t.detach()) - t.detach())
