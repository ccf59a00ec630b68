"""Per-class score selection of the streaming detection head.

Port of the selection stage of `ron_tensorflow_tpu/inference/detector.py`
(`Detector.postprocess`), which replaces the reference's per-class dict
selection (ref: nets/ssd_common.py:503-590) with a class axis.
"""

from __future__ import annotations

import torch


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
