"""Precision/recall curves and Pascal VOC average precision.

A copy of `ron_tensorflow_tpu/ops/ap.py` (numpy only), kept here so that
the port imports nothing of the JAX package.

Host-side (numpy, float64) equivalents of the reference's streaming metric
tail (ref: tf_extended/metrics.py:100-130 `precision_recall`, :212-234
`average_precision_voc12`, :237-258 `average_precision_voc07`,
tf_extended/math.py:41-67 `cummax`). These run on accumulated detection
arrays after the device-side matching, so plain numpy is the right tool —
the reference's growing `tf.assign(validate_shape=False)` accumulators
become host arrays.
"""

from __future__ import annotations

import numpy as np


def precision_recall(
    n_gt: int, tp: np.ndarray, fp: np.ndarray, scores: np.ndarray
) -> tuple[np.ndarray, np.ndarray]:
    """Precision/recall from TP/FP marks, sorted by descending score.

    (ref: tf_extended/metrics.py:100-130.)
    """
    order = np.argsort(-scores, kind="stable")
    tp = np.cumsum(tp[order].astype(np.float64))
    fp = np.cumsum(fp[order].astype(np.float64))
    recall = tp / n_gt if n_gt > 0 else np.zeros_like(tp)
    denom = tp + fp
    precision = np.where(denom > 0, tp / np.where(denom > 0, denom, 1.0), 0.0)
    return precision, recall


def average_precision_voc07(precision: np.ndarray, recall: np.ndarray) -> float:
    """11-point interpolated AP, Pascal VOC 2007 protocol
    (ref: tf_extended/metrics.py:237-258)."""
    precision = np.concatenate([precision.astype(np.float64), [0.0]])
    recall = np.concatenate([recall.astype(np.float64), [np.inf]])
    ap = 0.0
    for t in np.arange(0.0, 1.1, 0.1):
        mask = recall >= t
        ap += np.max(precision[mask]) / 11.0
    return float(ap)


def average_precision_voc12(precision: np.ndarray, recall: np.ndarray) -> float:
    """Integral AP with monotone (reverse-cummax) precision envelope,
    Pascal VOC 2012 protocol (ref: tf_extended/metrics.py:212-234)."""
    precision = np.concatenate([[0.0], precision.astype(np.float64), [0.0]])
    recall = np.concatenate([[0.0], recall.astype(np.float64), [1.0]])
    # Reverse cumulative max — precision non-increasing in recall.
    precision = np.maximum.accumulate(precision[::-1])[::-1]
    mean_pre = precision[1:]
    diff_rec = recall[1:] - recall[:-1]
    return float(np.sum(mean_pre * diff_rec))


class StreamingTpFp:
    """Streaming accumulator of (scores, tp, fp, n_gt) per class.

    Host-side replacement for the reference's growing local-variable
    accumulators (ref: tf_extended/metrics.py:133-206
    `streaming_tp_fp_arrays`). Zero-score entries and entries that are
    neither TP nor FP are dropped, matching `remove_zero_scores` with its
    1e-4 threshold.
    """

    RM_THRESHOLD = 1e-4

    def __init__(self, num_classes: int):
        self.num_classes = num_classes
        self.n_gt = np.zeros((num_classes,), dtype=np.int64)
        self._scores = [[] for _ in range(num_classes)]
        self._tp = [[] for _ in range(num_classes)]
        self._fp = [[] for _ in range(num_classes)]

    def add(self, cls: int, n_gt, scores, tp, fp):
        scores = np.asarray(scores).reshape(-1)
        tp = np.asarray(tp).reshape(-1).astype(bool)
        fp = np.asarray(fp).reshape(-1).astype(bool)
        mask = (tp | fp) & (scores > self.RM_THRESHOLD)
        self.n_gt[cls] += int(np.sum(n_gt))
        self._scores[cls].append(scores[mask])
        self._tp[cls].append(tp[mask])
        self._fp[cls].append(fp[mask])

    def class_arrays(self, cls: int):
        if self._scores[cls]:
            return (
                np.concatenate(self._scores[cls]),
                np.concatenate(self._tp[cls]),
                np.concatenate(self._fp[cls]),
            )
        z = np.zeros((0,))
        return z, z.astype(bool), z.astype(bool)

    def average_precision(self, cls: int, protocol: str = "voc07") -> float:
        scores, tp, fp = self.class_arrays(cls)
        if scores.size == 0 or self.n_gt[cls] == 0:
            return 0.0
        prec, rec = precision_recall(int(self.n_gt[cls]), tp, fp, scores)
        if protocol == "voc07":
            return average_precision_voc07(prec, rec)
        if protocol == "voc12":
            return average_precision_voc12(prec, rec)
        raise ValueError(f"unknown AP protocol {protocol!r}")

    def mean_average_precision(self, protocol: str = "voc07", skip_background=True):
        start = 1 if skip_background else 0
        aps = {c: self.average_precision(c, protocol) for c in range(start, self.num_classes)}
        return float(np.mean(list(aps.values()))), aps
