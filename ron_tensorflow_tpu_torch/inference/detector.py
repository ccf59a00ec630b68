"""Streaming detection head, pixels to boxes.

Port of `ron_tensorflow_tpu/inference/detector.py::Detector` (the
reference's eval_ron_network.py:224-236 + nets/ron_vgg_320.py:234-256
`detected_bboxes`): binary objectness gate -> per-class select -> clip ->
min-size filter -> exact per-class top-k -> class-wise 'min'-mode NMS ->
[B, C-1, keep_top_k].
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from .. import resolve_device
from ..kernels.nms import nms_sorted_kernel
from ..models.ron import RON, DetectorOutputs
from ..models.spec import DetectorSpec
from ..ops import boxes as boxops
from ..ops.decode import decode_boxes
from ..ops.math import exact_top_k_chunked
from ..ops.select import masked_class_scores

# Chunks of the per-class top-k: exact for any value. 16 chunks of ~1330
# anchors each sort faster on the H100 than one sort of all 21 250
# (PERF.md, Findings, PR 4).
TOPK_CHUNKS = 16


@dataclasses.dataclass(frozen=True)
class DetectionConfig:
    """Streaming-eval defaults (ref: eval_ron_network.py:64-75). NMS runs
    the fixpoint keep-mask kernel for CUDA tensors and its plain version for
    CPU tensors: the choice follows the tensors' device, never a global
    default."""

    select_threshold: float = 0.01
    objectness_threshold: float = 0.03
    top_k: int = 200
    keep_top_k: int = 100
    nms_threshold: float = 0.4
    nms_mode: str = "min"
    min_size: float = 0.03


class Detector:
    """Class-wise detection head over a RON model on one device."""

    def __init__(
        self,
        model: RON,
        spec: DetectorSpec,
        config: DetectionConfig = DetectionConfig(),
        device="cuda",
    ):
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.spec = spec
        self.config = config
        self.anchors = torch.as_tensor(spec.anchor_layout().cyxhw, device=self.device)

    @torch.inference_mode()
    def __call__(self, images) -> Tuple[torch.Tensor, torch.Tensor]:
        """images [B, H, W, 3] whitened (numpy or tensor) ->
        (scores [B, C-1, keep_top_k], boxes [B, C-1, keep_top_k, 4])."""
        images = torch.as_tensor(images, device=self.device)
        return self.postprocess(self.model(images))

    def class_scores(self, out: DetectorOutputs) -> Tuple[torch.Tensor, torch.Tensor]:
        """Decode and gate: -> (per-class scores [B, C-1, N], 0 where
        gated out; decoded boxes [B, N, 4], shared by all classes)."""
        cfg = self.config
        decoded = decode_boxes(out.locations, self.anchors, self.spec.prior_scaling)
        decoded = boxops.clip_to_ref(decoded)
        base = (out.objness_pred > cfg.objectness_threshold) & boxops.min_size_mask(
            decoded, cfg.min_size
        )
        return masked_class_scores(out.predictions, base, cfg.select_threshold), decoded

    def candidates(self, out: DetectorOutputs) -> Tuple[torch.Tensor, torch.Tensor]:
        """Decode, gate and select: -> per-class top-k candidates, score
        sorted, as NMS rows: scores [B*(C-1), top_k], boxes
        [B*(C-1), top_k, 4]."""
        cfg = self.config
        scores, decoded = self.class_scores(out)
        b, c, n = scores.shape
        k = min(cfg.top_k, n)
        top_scores, top_idx = exact_top_k_chunked(scores, k, TOPK_CHUNKS)
        top_boxes = torch.gather(
            decoded[:, None].expand(b, c, n, 4), 2, top_idx[..., None].expand(b, c, k, 4)
        )
        if k < cfg.top_k:
            pad = cfg.top_k - k
            top_scores = torch.nn.functional.pad(top_scores, (0, pad))
            top_boxes = torch.nn.functional.pad(top_boxes, (0, 0, 0, pad))
        return top_scores.reshape(b * c, -1), top_boxes.reshape(b * c, -1, 4)

    def postprocess(self, out: DetectorOutputs) -> Tuple[torch.Tensor, torch.Tensor]:
        cfg = self.config
        b, c = out.predictions.shape[0], out.predictions.shape[-1] - 1
        flat_s, flat_b = self.candidates(out)
        s, bx = nms_sorted_kernel(flat_s, flat_b, cfg.nms_threshold, cfg.keep_top_k, cfg.nms_mode)
        return s.reshape(b, c, -1), bx.reshape(b, c, -1, 4)
