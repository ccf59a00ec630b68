"""Detection heads, pixels to boxes.

Port of `ron_tensorflow_tpu/inference/detector.py`:

- `Detector`, the streaming-eval head (the reference's
  eval_ron_network.py:224-236 + nets/ron_vgg_320.py:234-256
  `detected_bboxes`): binary objectness gate -> per-class select -> clip ->
  min-size filter -> (optional whole-image preselection, `shared_top_k`)
  -> exact per-class top-k -> class-wise 'min'-mode NMS (`nms_method`:
  K-A or K-C) -> [B, C-1, keep_top_k].
- `RealtimeDetector`, the realtime head that produced the published mAP
  (ref: ron_eval.py:428-594): score = objectness x class probability,
  argmax label, objectness gate 0.95 -> clip -> min-size and centre
  filters -> whole-image union-mode NMS (K-C) -> [B, keep_top_k] detections
  with labels. Its class-wise mode runs per-class top-k and per-class NMS
  (K-C) instead, then one whole-image top-k.

Both heads take any detector module whose forward maps whitened images
[B, H, W, 3] to `DetectorOutputs` (RON, SSD); SSD's constant objectness of
1 passes the gates (the SSD eval preset sets its objectness threshold to 0,
and `RealtimeConfig.for_spec` picks class-wise mode for it).

The Detector's `nms_method` takes JAX's names (`detector.py:71`, `:246-310`),
which are not the port's kernel names: JAX's 'fixpoint' is its XLA
suppression fixpoint with the dividing predicate, which keeps what its
sequential 'loop' keeps; the port's `method="fixpoint"` is K-A.

| nms_method          | CUDA rows | CPU rows              |
|---------------------|-----------|-----------------------|
| 'loop', 'fixpoint'  | K-C       | K-C's plain version   |
| 'pallas'            | K-A       | K-A's plain version   |
| 'auto'              | K-A       | K-C's plain version   |

K-C (`kernels.nms.nms_scan_keep_mask`) divides, `inter / denom >= t`, as
JAX's 'loop' and 'fixpoint' do; K-A (`nms_fixpoint_keep_mask`) compares
`inter >= t * denom`, as JAX's Pallas kernel does. The two can part on a
pair whose overlap lies within one rounding of the threshold. JAX's
'auto' runs the loop on the CPU and the Pallas kernel elsewhere, so the
port's 'auto' runs K-C's plain version for CPU rows: then a CPU Detector
keeps what JAX's CPU Detector keeps on such a pair too
(tests/test_torch_nms_method.py holds one). The choice follows the rows'
device, never a global default, on one device and in each rank of a mesh
eval alike.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from .. import resolve_device
from ..kernels.nms import nms_sorted_kernel
from ..models.ron import DetectorOutputs
from ..models.spec import DetectorSpec
from ..ops import boxes as boxops
from ..ops.decode import decode_boxes
from ..ops.math import exact_top_k_chunked, flush_subnormal
from ..ops.nms import TOPK_CHUNKS, nms_per_class, nms_sorted_with_labels, top_k_with_labels

NMS_METHODS = ("auto", "loop", "fixpoint", "pallas")
from ..ops.select import masked_class_scores, top_k_per_class


@dataclasses.dataclass(frozen=True)
class DetectionConfig:
    """Streaming-eval defaults (ref: eval_ron_network.py:64-75), and JAX's
    selection and NMS knobs with its names and defaults
    (`detector.py:60-88`). `nms_method` picks the keep-mask kernel by the
    module docstring's table; every method keeps the same set on rows with
    no overlap at the threshold.

    Selection is exact for any `approx_top_k`: the field is kept so that
    JAX's configs load, and has no effect, as JAX's `lax.approx_max_k`
    selects exactly off the TPU."""

    select_threshold: float = 0.01
    objectness_threshold: float = 0.03
    top_k: int = 200
    keep_top_k: int = 100
    nms_threshold: float = 0.4
    nms_mode: str = "min"
    min_size: float = 0.03
    approx_top_k: bool = False  # no effect: selection is exact
    # chunks of the exact top-k, bit-identical for any value (0 and 1: one
    # whole-row selection); 16 chunks of ~1330 anchors each sort faster on
    # the H100 than one sort of all 21 250 (PERF.md, Findings)
    topk_chunks: int = TOPK_CHUNKS
    nms_method: str = "auto"  # 'auto' | 'loop' | 'fixpoint' | 'pallas'
    # no effect: JAX's split into two XLA programs works around a libtpu
    # crash; the port's forward and postprocess already run as separate calls
    split_apply: bool = False
    # Whole-image preselection (0: off, the reference's semantics): one
    # top-K of each anchor's largest class probability behind the gate,
    # then every class selects among those K anchors only. An anchor outside
    # them is dropped for every class.
    shared_top_k: int = 0


class Detector:
    """Class-wise detection head over a detector model (RON, SSD) on one device."""

    def __init__(
        self,
        model: torch.nn.Module,
        spec: DetectorSpec,
        config: DetectionConfig = DetectionConfig(),
        device="cuda",
    ):
        if config.nms_method not in NMS_METHODS:
            raise ValueError(f"unknown nms_method {config.nms_method!r}; options: {NMS_METHODS}")
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
        """Decode, gate and preselect: -> (per-class scores [B, C-1, N],
        0 where gated out; decoded boxes [B, N, 4], shared by all classes),
        N the anchors, or the `shared_top_k` preselected ones (JAX
        `detector.py:184-223`: the gate is gathered with them, and the
        select threshold masks the scores after the gather)."""
        cfg = self.config
        decoded = decode_boxes(out.locations, self.anchors, self.spec.prior_scaling)
        decoded = boxops.clip_to_ref(decoded)
        base = (out.objness_pred > cfg.objectness_threshold) & boxops.min_size_mask(
            decoded, cfg.min_size
        )
        predictions = out.predictions
        b, n, c = predictions.shape
        if 0 < cfg.shared_top_k < n:
            zero = torch.zeros((), dtype=predictions.dtype, device=predictions.device)
            m = torch.where(base, predictions[..., 1:].amax(dim=-1), zero)  # [B, N]
            _, cand = exact_top_k_chunked(m, cfg.shared_top_k, cfg.topk_chunks)  # [B, K], ties to the lower index
            predictions = torch.gather(predictions, 1, cand[..., None].expand(b, -1, c))
            decoded = torch.gather(decoded, 1, cand[..., None].expand(b, -1, 4))
            base = torch.gather(base, 1, cand)
        return masked_class_scores(predictions, base, cfg.select_threshold), decoded

    def candidates(self, out: DetectorOutputs) -> Tuple[torch.Tensor, torch.Tensor]:
        """Decode, gate and select: -> per-class top-k candidates, score
        sorted, as NMS rows: scores [B*(C-1), top_k], boxes
        [B*(C-1), top_k, 4]."""
        cfg = self.config
        scores, decoded = self.class_scores(out)
        b, c, n = scores.shape
        k = min(cfg.top_k, n)
        top_scores, top_boxes = top_k_per_class(scores, decoded, k, cfg.topk_chunks)
        if k < cfg.top_k:
            pad = cfg.top_k - k
            top_scores = torch.nn.functional.pad(top_scores, (0, pad))
            top_boxes = torch.nn.functional.pad(top_boxes, (0, 0, 0, pad))
        return top_scores.reshape(b * c, -1), top_boxes.reshape(b * c, -1, 4)

    def keep_mask_kernel(self, rows: torch.Tensor) -> str:
        """The port's keep-mask method for `nms_method` on rows on
        `rows.device`: 'fixpoint' (K-A) or 'scan' (K-C)."""
        method = self.config.nms_method
        if method == "auto":
            method = "pallas" if rows.device.type == "cuda" else "loop"
        return "fixpoint" if method == "pallas" else "scan"

    def postprocess(self, out: DetectorOutputs) -> Tuple[torch.Tensor, torch.Tensor]:
        cfg = self.config
        b, c = out.predictions.shape[0], out.predictions.shape[-1] - 1
        flat_s, flat_b = self.candidates(out)
        s, bx = nms_sorted_kernel(flat_s, flat_b, cfg.nms_threshold, cfg.keep_top_k, cfg.nms_mode,
                                  method=self.keep_mask_kernel(flat_s))
        return s.reshape(b, c, -1), bx.reshape(b, c, -1, 4)


@dataclasses.dataclass(frozen=True)
class RealtimeConfig:
    """Realtime-eval defaults: the reference's published flag values
    (ref: ron_eval.py:83-91: select 0.6, NMS 0.4, objectness 0.95, nms_topk
    20). Both modes run the capped scan NMS (K-C) with its dividing
    predicate, for CUDA tensors the kernel and for CPU tensors its plain
    version."""

    select_threshold: float = 0.6
    objectness_threshold: float = 0.95
    # static cap on the candidates that reach NMS (the reference sorts every
    # gated candidate; the 0.95 objectness gate keeps far fewer than 400)
    top_k: int = 400
    keep_top_k: int = 20
    nms_threshold: float = 0.4
    nms_mode: str = "union"
    # min-size ratio relative to the net input; at detection time the caller
    # scales it by sqrt(H0*W0 / (320*320)) of the original frame
    # (ref: ron_eval.py:369-375 filter_boxes)
    min_size: float = 0.03
    # Class-wise mode: per-class top-k and per-class NMS (the streaming
    # `detected_bboxes` semantics), then one whole-image top-k, instead of
    # ron_eval.py's argmax-class flatten and class-blind whole-image NMS,
    # which suits only detectors with a sharp objectness gate.
    # `for_spec` picks it for detectors without an objectness branch.
    class_wise: bool = False
    keep_per_class: int = 100  # per-class NMS survivors before the flatten

    @classmethod
    def for_spec(cls, spec, **overrides):
        """The published ron_eval.py flags for objectness models; for
        detectors without an objectness prior, class-wise settings with the
        streaming eval's select, top-k and NMS values."""
        if getattr(spec, "has_objectness", True):
            return dataclasses.replace(cls(), **overrides)
        base = cls(
            class_wise=True,
            select_threshold=0.01,
            objectness_threshold=0.0,
            top_k=200,
            keep_per_class=100,
            keep_top_k=200,
            nms_mode="min",
        )
        overrides.pop("objectness_threshold", None)  # objectness is 1 for these
        return dataclasses.replace(base, **overrides)


class RealtimeDetector:
    """Whole-image NMS detection head over a detector model (RON, SSD) on one
    device; class-wise in the mode `RealtimeConfig.for_spec` picks for SSD."""

    def __init__(
        self,
        model: torch.nn.Module,
        spec: DetectorSpec,
        config: RealtimeConfig = RealtimeConfig(),
        device="cuda",
    ):
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.spec = spec
        self.config = config
        self.anchors = torch.as_tensor(spec.anchor_layout().cyxhw, device=self.device)

    @torch.inference_mode()
    def __call__(self, images, min_size=None):
        """images [B, H, W, 3] whitened (numpy or tensor) -> (scores,
        labels int32, boxes, valid) each [B, keep_top_k(, 4)], score sorted,
        zero-filled past the valid ones.

        min_size: None (config.min_size), a scalar or a per-image [B]
        vector. The caller passes `config.min_size * sqrt(H0*W0 / (Hnet*Wnet))`
        so that the filter scales with each original frame
        (ref: ron_eval.py:369-375)."""
        images = torch.as_tensor(images, device=self.device)
        return self.postprocess(self.model(images), min_size)

    def postprocess(self, out: DetectorOutputs, min_size=None):
        return self.nms(self.candidates(out, min_size))

    def min_sizes(self, min_size, batch: int) -> torch.Tensor:
        """max(float32(min_size), 1e-4) broadcast to [B] (`detector.py:328-331`)."""
        if min_size is None:
            min_size = self.config.min_size
        ms = torch.as_tensor(min_size, dtype=torch.float32, device=self.device)
        floor = torch.tensor(1e-4, dtype=torch.float32, device=self.device)
        return torch.maximum(ms, floor).broadcast_to((batch,))

    def candidates(self, out: DetectorOutputs, min_size=None):
        """Decode, score, gate and select: the score-sorted NMS rows.

        Whole-image mode: (scores, labels int32, boxes, valid) [B, top_k(, 4)],
        the top_k valid candidates of each image. Class-wise mode: per-class
        rows (scores [B*(C-1), top_k], boxes [B*(C-1), top_k, 4])."""
        cfg = self.config
        b = out.predictions.shape[0]
        ms = self.min_sizes(min_size, b)[:, None]
        boxes = boxops.clip_to_ref(decode_boxes(out.locations, self.anchors, self.spec.prior_scaling))
        # Subnormal probabilities and scores are 0 in the JAX package: they
        # must not pass a threshold of 0 or decide an argmax here either.
        if cfg.class_wise:
            objness = flush_subnormal(out.objness_pred)
            base = (objness > cfg.objectness_threshold) & boxops.min_size_mask(boxes, ms)
            scores = masked_class_scores(flush_subnormal(out.predictions), base, cfg.select_threshold)  # [B, C-1, N]
            _, c, n = scores.shape
            k = min(cfg.top_k, n)
            top_scores, top_boxes = top_k_per_class(scores, boxes, k, TOPK_CHUNKS)
            return top_scores.reshape(b * c, k), top_boxes.reshape(b * c, k, 4)
        # score = objectness x class probability; the label is the argmax
        # class, the first of equal maxima (ref: ron_eval.py:111-144
        # flaten_predict). Both factors are probabilities (<= 1), so a
        # subnormal factor gives a product that is flushed too: an anchor
        # whose products are all 0 takes label 0 and is invalid.
        scores_nc = flush_subnormal(out.objness_pred[..., None] * out.predictions)
        labels = torch.argmax(scores_nc, dim=-1).to(torch.int32)
        max_scores = torch.amax(scores_nc, dim=-1)
        valid = (labels > 0) & (out.objness_pred > cfg.objectness_threshold)
        valid &= max_scores > cfg.select_threshold  # ref: ron_eval.py:151-153
        # min-size and centre-inside filters on the clipped boxes
        # (ref: ron_eval.py:369-392)
        valid &= boxops.min_size_mask(boxes, ms)
        cy = (boxes[..., 0] + boxes[..., 2]) / 2.0
        cx = (boxes[..., 1] + boxes[..., 3]) / 2.0
        valid &= (cy > 0.0) & (cy < 1.0) & (cx > 0.0) & (cx < 1.0)
        return top_k_with_labels(max_scores, labels, boxes, valid, cfg.top_k)

    def nms(self, rows):
        """NMS of `candidates`' rows through K-C -> (scores, labels int32,
        boxes, valid) [B, keep_top_k(, 4)]."""
        cfg = self.config
        if not cfg.class_wise:
            return nms_sorted_with_labels(*rows, cfg.nms_threshold, cfg.keep_top_k, cfg.nms_mode)
        top_scores, top_boxes = rows
        c = self.spec.num_classes - 1
        b = top_scores.shape[0] // c
        s, bx = nms_per_class(top_scores, top_boxes, cfg.nms_threshold, cfg.keep_per_class, cfg.nms_mode)
        flat_s, flat_b = s.reshape(b, -1), bx.reshape(b, -1, 4)
        labels = torch.arange(1, c + 1, dtype=torch.int32, device=s.device).repeat_interleave(cfg.keep_per_class)
        kk = min(cfg.keep_top_k, flat_s.shape[-1])
        vals, idx = exact_top_k_chunked(flat_s, kk, TOPK_CHUNKS)
        boxes = torch.gather(flat_b, 1, idx[..., None].expand(-1, -1, 4))
        return vals, labels[idx], boxes, vals > 0
