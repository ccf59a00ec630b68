"""Evaluation: streaming mAP, realtime VOCdevkit evaluation, offline VOC AP."""

from .evaluator import StreamingEvaluator
from .realtime import RealtimeEvaluator
from .voc_eval import ClassGroundTruth, PascalVocEvaluator, evaluate_class, voc_ap

__all__ = [
    "StreamingEvaluator",
    "RealtimeEvaluator",
    "ClassGroundTruth",
    "PascalVocEvaluator",
    "evaluate_class",
    "voc_ap",
]
