"""Per-class score selection of the streaming detection head.

Port of the selection stage of `ron_tensorflow_tpu/inference/detector.py`
(`Detector.postprocess`), which replaces the reference's per-class dict
selection (ref: nets/ssd_common.py:503-590) with a class axis.
"""

from __future__ import annotations

import torch

from .math import exact_top_k_chunked


def masked_class_scores(
    predictions: torch.Tensor, base: torch.Tensor, select_threshold: float
) -> torch.Tensor:
    """predictions [B, N, C] class probabilities, base [B, N] bool gate ->
    foreground scores [B, C-1, N], zero where the gate is closed or the
    score is not above `select_threshold` (strict >, as the reference).
    Boxes are not materialized per class: callers gather them after top-k."""
    scores = predictions[..., 1:].transpose(-1, -2)
    keep = base[:, None, :] & (scores > select_threshold)
    return torch.where(keep, scores, torch.zeros((), dtype=scores.dtype, device=scores.device))


def top_k_per_class(scores: torch.Tensor, boxes: torch.Tensor, k: int, num_chunks: int):
    """Each class's k best anchors and their boxes: scores [B, C, N], boxes
    [B, N, 4] shared by the classes -> (scores [B, C, k] sorted, boxes
    [B, C, k, 4]). The exact chunked top-k, so ties go to the lower anchor
    index as with `lax.top_k`, for any `num_chunks`."""
    b, c, n = scores.shape
    top_scores, top_idx = exact_top_k_chunked(scores, k, num_chunks)
    top_boxes = torch.gather(boxes[:, None].expand(b, c, n, 4), 2, top_idx[..., None].expand(b, c, k, 4))
    return top_scores, top_boxes
