"""Detection <-> ground-truth TP/FP matching for mAP evaluation.

Port of `ron_tensorflow_tpu/ops/matching.py` (the reference's greedy
matcher, tf_extended/bboxes.py:305-450 `bboxes_matching`): detections are
visited in descending-score order; a detection is TP iff its best
same-class gt has IoU > threshold and is not yet matched; a difficult gt
gives neither TP nor FP. Plain PyTorch (no TPU kernel computes it), on the
device of its inputs, with the reference's quirks kept bit for bit:

- on a row of all-zero IoUs the argmax is gt 0, so `fp` follows that gt's
  difficult flag even when it is of another class or padding;
- zero-score padding detections are matched too (the host accumulator
  drops them, `StreamingTpFp`);
- the IoU is 0 where the union is 0, and a match needs IoU > threshold.

The JAX matcher is a K-step loop whose only state is the set of gts
already matched. That state has a closed form: detection i finds its gt
g = argmax(IoU_i) already matched iff an earlier detection j < i claimed
the same g (not difficult, IoU > threshold); gts are never unmatched. So
the whole [..., K] row is decided at once, from a [..., K, K] comparison,
with the same result and a few launches instead of K.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .boxes import jaccard_one_to_many


class MatchResult(NamedTuple):
    n_gt: torch.Tensor  # [...] int32: non-difficult gts of the class
    tp: torch.Tensor  # [..., K] bool
    fp: torch.Tensor  # [..., K] bool


def match_detections(label, scores, boxes, glabels, gboxes, gdifficults,
                     matching_threshold: float = 0.5) -> MatchResult:
    """Match detections of one class against the ground truth.

    label [...] int (the class), scores [..., K] descending (zero padding
    allowed; only their order matters), boxes [..., K, 4], glabels [..., G]
    (0 = padding), gboxes [..., G, 4], gdifficults [..., G] bool or int;
    leading axes broadcast. One image and one class: label [], scores [K]."""
    label = torch.as_tensor(label, device=boxes.device)
    gdiff = gdifficults.bool()
    same_class = glabels == label[..., None]  # [..., G]
    n_gt = (same_class & ~gdiff).sum(-1, dtype=torch.int32)
    jac = jaccard_one_to_many(boxes, gboxes[..., None, :, :])  # [..., K, G]
    jac = jac * same_class[..., None, :].to(jac.dtype)
    best = torch.argmax(jac, dim=-1)  # [..., K]: the first maximum
    match = torch.gather(jac, -1, best[..., None])[..., 0] > matching_threshold
    k = scores.shape[-1]
    gdiff_k = gdiff[..., None, :].expand(*best.shape, gdiff.shape[-1])  # [..., K, G]
    not_difficult = ~torch.gather(gdiff_k, -1, best[..., None])[..., 0]
    claims = not_difficult & match
    earlier = torch.ones(k, k, dtype=torch.bool, device=boxes.device).tril(-1)  # [i, j]: j < i
    existing = ((best[..., :, None] == best[..., None, :]) & claims[..., None, :] & earlier).any(-1)
    return MatchResult(n_gt=n_gt, tp=claims & ~existing, fp=not_difficult & (existing | ~match))


# One class over a batch, scores [B, K], boxes [B, K, 4], glabels [B, G], ...
# (ref: tf_extended/bboxes.py:407-450 `bboxes_matching_batch`): the same
# function, its leading axes broadcast.
match_detections_batch = match_detections


def match_all_classes(num_classes: int, scores, boxes, glabels, gboxes, gdifficults,
                      matching_threshold: float = 0.5) -> MatchResult:
    """Per-class detection stacks of classes 1..num_classes-1: scores
    [..., C-1, K] (class c at row c-1), boxes [..., C-1, K, 4], the gts of
    their image glabels [..., G], gboxes [..., G, 4], gdifficults [..., G]
    -> MatchResult with a class axis [..., C-1(, K)]."""
    labels = torch.arange(1, num_classes, device=boxes.device)
    return match_detections(labels, scores, boxes, glabels[..., None, :], gboxes[..., None, :, :],
                            gdifficults[..., None, :], matching_threshold)
