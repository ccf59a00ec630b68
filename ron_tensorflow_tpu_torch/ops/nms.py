"""Fixed-shape greedy non-max suppression over batched rows.

Port of `ron_tensorflow_tpu/ops/nms.py`: the score sort, greedy NMS of
score-sorted rows (`nms_sorted`, `nms_sorted_fixpoint`) and of unsorted
ones (`nms`), the whole-image NMS with labels of the realtime head
(`nms_with_labels`) and class-wise NMS (`nms_per_class`). Every keep mask
here is K-C,
`kernels.nms.nms_scan_keep_mask`: the capped greedy scan with the dividing
predicate `inter / denom >= t` (0 where denom <= 0) of `overlap_matrix`,
the predicate of every NMS these functions replace. It runs the CUDA
kernel for a CUDA tensor and its plain version for a CPU tensor. Rows are
[R, K]: the JAX functions take one row and are vmapped. `nms_sorted`,
`nms_sorted_fixpoint` and `nms` take one row [K] as well, as JAX's do.
"""

from __future__ import annotations

import torch

from ..kernels.nms import compact_keep_labelled, nms_scan_keep_mask, nms_sorted_kernel
from .math import exact_top_k_chunked

# Chunks of the exact top-k, as `sort_by_score` and the realtime head use
# in the JAX package (`ops/nms.py:58`, `detector.py:387`); also the
# default of `DetectionConfig.topk_chunks`.
TOPK_CHUNKS = 16


def overlap_matrix(boxes: torch.Tensor, mode: str = "union") -> torch.Tensor:
    """Pairwise overlap used for suppression, [..., K, 4] -> [..., K, K].
    'union': IoU; 'min': intersection / min(area_i, area_j); 0 where the
    denominator is not > 0 (ref: tf_extended/bboxes.py:193-212). Plain: the
    keep masks compute it pair by pair."""
    b_i, b_j = boxes[..., :, None, :], boxes[..., None, :, :]
    ymin = torch.maximum(b_i[..., 0], b_j[..., 0])
    xmin = torch.maximum(b_i[..., 1], b_j[..., 1])
    ymax = torch.minimum(b_i[..., 2], b_j[..., 2])
    xmax = torch.minimum(b_i[..., 3], b_j[..., 3])
    inter = torch.clamp(ymax - ymin, min=0.0) * torch.clamp(xmax - xmin, min=0.0)
    vol = (boxes[..., 2] - boxes[..., 0]) * (boxes[..., 3] - boxes[..., 1])
    if mode == "union":
        denom = vol[..., :, None] + vol[..., None, :] - inter
    elif mode == "min":
        denom = torch.minimum(vol[..., :, None], vol[..., None, :])
    else:
        raise ValueError(f"unknown NMS mode: {mode!r}")
    pos = denom > 0
    return torch.where(pos, inter / torch.where(pos, denom, 1.0), 0.0)


def _gather_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x [R, N(, 4)] at idx [R, k] -> [R, k(, 4)]."""
    if x.dim() == idx.dim():
        return torch.gather(x, 1, idx)
    return torch.gather(x, 1, idx[..., None].expand(-1, -1, x.shape[-1]))


def sort_by_score(scores: torch.Tensor, boxes: torch.Tensor, top_k: int):
    """Descending score sort of rows [R, N] / [R, N, 4], keeping top_k and
    zero-padding when N < top_k (ref: tf_extended/bboxes.py:60-103). The
    exact chunked top-k: ties go to the lower index, as `lax.top_k`."""
    k = min(top_k, scores.shape[-1])
    s, idx = exact_top_k_chunked(scores, k, TOPK_CHUNKS)
    b = _gather_rows(boxes, idx)
    if k < top_k:
        s = torch.nn.functional.pad(s, (0, top_k - k))
        b = torch.nn.functional.pad(b, (0, 0, 0, top_k - k))
    return s, b


def _one_row_or_rows(fn, scores, boxes, *args):
    """fn over rows [R, K] / [R, K, 4]; a single row [K] / [K, 4] goes
    through as one row and comes back without the row axis."""
    if scores.dim() == 1:
        return tuple(t[0] for t in fn(scores[None], boxes[None], *args))
    return fn(scores, boxes, *args)


def nms_sorted(scores, boxes, nms_threshold: float = 0.5, keep_top_k: int = 200, mode: str = "min"):
    """Greedy NMS over score-sorted candidates (`ops/nms.py:67-111`): a
    candidate is taken where its score is > 0, it is not suppressed and
    fewer than keep_top_k are kept; a taken one suppresses each later one
    whose overlap is >= nms_threshold. scores [K] or [R, K], boxes [K, 4]
    or [R, K, 4] -> (scores [(R,) keep_top_k], boxes [(R,) keep_top_k, 4]),
    zero-padded, in score order. K-C's keep mask."""
    return _one_row_or_rows(nms_per_class, scores, boxes, nms_threshold, keep_top_k, mode)


def nms_sorted_fixpoint(scores, boxes, nms_threshold: float = 0.5, keep_top_k: int = 200, mode: str = "min"):
    """JAX's suppression-fixpoint NMS (`ops/nms.py:114-158`), which keeps
    exactly what `nms_sorted` keeps: the uncapped fixpoint with the
    dividing predicate, then the cap, gives the capped greedy scan's set.
    So it is `nms_sorted`, K-C's keep mask."""
    return nms_sorted(scores, boxes, nms_threshold, keep_top_k, mode)


def nms(scores, boxes, nms_threshold: float = 0.5, top_k: int = 400, keep_top_k: int = 200, mode: str = "min"):
    """Sort + greedy NMS, for unsorted candidates (`ops/nms.py:161-165`):
    scores [N] or [R, N], boxes [N, 4] or [R, N, 4] ->
    [(R,) keep_top_k(, 4)]."""
    return _one_row_or_rows(
        lambda s, b: nms_per_class(*sort_by_score(s, b, top_k), nms_threshold, keep_top_k, mode), scores, boxes)


def top_k_with_labels(scores, labels, boxes, valid, top_k: int = 400):
    """The candidates of the whole-image NMS: the top_k highest scores among
    the valid ones (invalid ones score 0), with their labels, boxes and
    valid flags gathered. Rows [R, N] -> [R, min(top_k, N)(, 4)], score
    sorted; ties go to the lower index, as `lax.top_k`
    (`ops/nms.py:196-203`)."""
    k = min(top_k, scores.shape[-1])
    masked = torch.where(valid, scores, torch.zeros((), dtype=scores.dtype, device=scores.device))
    s, idx = exact_top_k_chunked(masked, k, TOPK_CHUNKS)
    return s, _gather_rows(labels, idx), _gather_rows(boxes, idx), _gather_rows(valid, idx)


def nms_sorted_with_labels(scores, labels, boxes, valid, nms_threshold: float = 0.5,
                           keep_top_k: int = 200, mode: str = "union"):
    """Greedy NMS over score-sorted rows that carry labels, taking candidate
    i only where valid[i] (`ops/nms.py:205-217`), at most keep_top_k a row.
    -> (scores, labels, boxes, valid) [R, keep_top_k(, 4)], zero-filled.

    K-C takes a candidate where its score is > 0; it reads the scores for
    nothing else. So it is given the valid flags as a 1.0/0.0 row, which
    takes exactly the valid candidates whatever their scores (a negative
    select threshold lets a candidate of score 0 be valid), and the real
    scores are compacted afterwards."""
    keep = nms_scan_keep_mask(valid.to(torch.float32), boxes.contiguous(), nms_threshold, keep_top_k, mode)
    return compact_keep_labelled(keep, scores, labels, boxes, keep_top_k)


def nms_with_labels(scores, labels, boxes, valid, nms_threshold: float = 0.5, top_k: int = 400,
                    keep_top_k: int = 200, mode: str = "union"):
    """Whole-image (class-agnostic) NMS carrying labels through, the
    realtime head's (ref: ron_eval.py:146-210 `tf_bboxes_nms`).

    scores [R, N] per-box max class scores, labels [R, N] int, boxes
    [R, N, 4], valid [R, N] bool (score, objectness, size and centre
    filters) -> (scores, labels, boxes, valid) [R, keep_top_k(, 4)], score
    sorted, zero-filled."""
    return nms_sorted_with_labels(*top_k_with_labels(scores, labels, boxes, valid, top_k),
                                  nms_threshold, keep_top_k, mode)


def nms_per_class(scores, boxes, nms_threshold: float = 0.5, keep_top_k: int = 200, mode: str = "min"):
    """Greedy NMS of score-sorted rows [R, K] / [R, K, 4], one class each,
    a candidate taken where its score is > 0: K-C with its cap, then the
    compaction -> [R, keep_top_k(, 4)] (`ops/nms.py:228-236`)."""
    return nms_sorted_kernel(scores, boxes, nms_threshold, keep_top_k, mode, method="scan")
