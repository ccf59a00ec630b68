"""Per-class score selection of the streaming detection head, and the
selection functions of `ron_tensorflow_tpu/ops/select.py`.

Port of the selection stage of `ron_tensorflow_tpu/inference/detector.py`
(`Detector.postprocess`), which replaces the reference's per-class dict
selection (ref: nets/ssd_common.py:503-590) with a class axis
(`masked_class_scores`, `top_k_per_class`), and of `ops/select.py`:
`select_per_class` (boxes materialized per class, which the Detector
avoids), `select_all_classes` and the realtime evaluator's objectness gate
`objectness_gated_predictions` (ref: ron_eval.py:111-144).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

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


def select_per_class(predictions: torch.Tensor, locations: torch.Tensor, select_threshold: float = 0.0,
                     ignore_class: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-class score thresholding (`select.py:17-44`; ref:
    nets/ssd_common.py:539-546, strict >): predictions [..., N, C],
    locations [..., N, 4] -> (scores [..., C-1, N], boxes [..., C-1, N, 4]),
    background dropped, both zeroed where the score is not above the
    threshold."""
    if ignore_class != 0:
        raise ValueError("only background=0 supported")
    scores = predictions[..., 1:].transpose(-1, -2)
    fmask = (scores > select_threshold).to(scores.dtype)
    scores = scores * fmask
    boxes = locations[..., None, :, :] * fmask[..., None]
    return scores, boxes.broadcast_to((*scores.shape, 4))


def select_all_classes(predictions: torch.Tensor, locations: torch.Tensor, select_threshold: Optional[float] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Combined-max selection, the best class of each box (`select.py:47-68`;
    ref: nets/ssd_common.py:592-630): -> (classes [..., N], scores [..., N],
    boxes [..., N, 4]). Without a threshold (None or 0) the argmax runs over
    all classes and a background argmax scores 0; with one, over the
    foreground classes, and a best score not above it gives class 0 and
    score 0. Ties go to the lower class, as `jnp.argmax`."""
    if not select_threshold:
        scores, classes = predictions.max(dim=-1)
        return classes, scores * (classes > 0).to(scores.dtype), locations
    scores, classes = predictions[..., 1:].max(dim=-1)
    mask = scores > select_threshold
    return (classes + 1) * mask.to(classes.dtype), scores * mask.to(scores.dtype), locations


class FlatPredictions(NamedTuple):
    scores: torch.Tensor  # [N, C] objectness-weighted class scores
    labels: torch.Tensor  # [N] argmax class
    valid: torch.Tensor  # [N] bool gate mask


def objectness_gated_predictions(predictions: torch.Tensor, objness: torch.Tensor,
                                 objectness_threshold: float = 0.95) -> FlatPredictions:
    """The objectness gate of the realtime evaluator (`select.py:77-94`;
    ref: ron_eval.py:111-144 `flaten_predict`): score = objectness x class
    probability; a box is valid where its argmax class is foreground and
    its objectness exceeds the gate. predictions [N, C], objness [N]."""
    scores = objness[:, None] * predictions
    labels = scores.argmax(dim=-1)
    return FlatPredictions(scores=scores, labels=labels, valid=(labels > 0) & (objness > objectness_threshold))
