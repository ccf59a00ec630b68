"""Streaming mAP evaluator, the `eval_ron_network` equivalent.

Port of `ron_tensorflow_tpu/eval/evaluator.py::StreamingEvaluator`
(ref: eval_ron_network.py:137-366). Per batch, on the device: the
`Detector` (forward, decode, gate, class-wise NMS through K-A) and the
per-class TP/FP matching; the small score and TP/FP arrays then go to the
host accumulator `StreamingTpFp`. Per-class AP (VOC07 and VOC12) and mAP at
the end. With `loss_config`, the model's losses of every batch too, from the
same forward as its detections (ref: eval_ron_network.py:208-236).

Over a mesh (`mesh=`, JAX `evaluator.py:31-52`): every rank reads the same
batches (the global batch) and runs the Detector, K-B and K-A included, on
its data rank's rows; the fixed-shape scores and boxes are gathered over
the data group in row order, and rank 0 matches and accumulates them, so
`StreamingTpFp` sees the one-process order and AP ties break the same way.
With `loss_config` the loss is the global batch's (each rank's share,
summed over the data group). Only rank 0 returns the mAP (the others
return None for it) and writes debug images.
"""

from __future__ import annotations

import time
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np
import torch

from ..data.preprocess import VGG_MEANS, whiten
from ..inference.detector import DetectionConfig, Detector
from ..ops.ap import StreamingTpFp
from ..ops.encode import TargetEncoder
from ..ops.matching import match_all_classes
from ..parallel.collectives import all_gather_rows
from ..parallel.multihost import sum_over
from ..train.state import detection_loss_fn


def copy_to_host(*tensors: torch.Tensor):
    """Start copying device tensors to the host behind the work queued so
    far, without waiting; `wait_host` waits and returns them as numpy."""
    if tensors[0].device.type != "cuda":
        return tensors, None
    host = tuple(t.to("cpu", non_blocking=True) for t in tensors)
    done = torch.cuda.Event()
    done.record()
    return host, done


def wait_host(copied):
    host, done = copied
    if done is not None:
        done.synchronize()
    return [t.numpy() for t in host]


class StreamingEvaluator:
    def __init__(
        self,
        model,
        spec,
        config: DetectionConfig = DetectionConfig(),
        matching_threshold: float = 0.5,
        device="cuda",
        loss_config=None,
        loss_match_threshold: float = 0.5,
        loss_ignore_threshold: float = 0.3,
        mesh=None,
    ):
        """loss_config: a `RonLossConfig` or `SsdLossConfig` to report the
        model's `loss/*` metrics of every batch beside the detections
        (`evaluator.py:32-72`), its targets encoded from the batch's gts
        (valid where the label is > 0) at the two thresholds.
        mesh: a `parallel.mesh.Mesh`; each batch's size must divide over its
        data axis (see the module's docstring)."""
        self.detector = Detector(model, spec, config, device=device)
        self.device = self.detector.device
        self.spec = spec
        self.matching_threshold = matching_threshold
        self.mesh = mesh
        self.primary = mesh is None or mesh.rank == 0
        group = mesh.data_group if mesh is not None else None
        self.accumulator: Optional[StreamingTpFp] = None  # the last run's
        self.batch_losses: List[Dict[str, float]] = []  # the last run's, batch by batch
        self._loss = None
        if loss_config is not None:
            self._encoder = TargetEncoder(spec.anchor_layout(), spec.img_shape, loss_match_threshold,
                                          loss_ignore_threshold, spec.prior_scaling)
            self._loss = detection_loss_fn(loss_config, group)

    def batch_loss(self, out, gt_labels, gt_boxes, bi: int, draws=None, rows=None) -> Dict[str, torch.Tensor]:
        """The `loss/*` metrics of batch `bi`'s outputs. RON's loss samples
        its negatives with `draws`, else with a generator seeded `bi` (the
        JAX evaluator's `PRNGKey(bi)`); SSD's draws nothing. With `rows`
        (offset, global batch), the outputs are a rank's rows, the draws the
        global batch's, and the metrics the global batch's."""
        targets = self._encoder.batched(gt_labels, gt_boxes, gt_labels > 0)
        generator = None if draws is not None else torch.Generator(device=self.device).manual_seed(bi)
        _, metrics = self._loss(out, targets, generator, draws, rows)
        losses = {k: v for k, v in metrics.items() if k.startswith("loss/")}
        return sum_over(losses, self.mesh.data_group) if self.mesh is not None else losses

    @torch.inference_mode()
    def run(
        self,
        batches: Iterator[Dict[str, np.ndarray]],
        max_batches: Optional[int] = None,
        log_every: int = 50,
        debug_dir: Optional[str] = None,
        debug_max_images: int = 64,
        debug_score_threshold: float = 0.5,
        loss_draws: Optional[Sequence] = None,
    ):
        """batches yield "image" (whitened float [B, H, W, 3], or uint8
        pixels, whitened on the device), padded GT "gt_labels" [B, G],
        "gt_boxes" [B, G, 4], "gt_difficult" [B, G], and optionally
        "sample_valid" [B] (False on the padding rows of a short batch).

        debug_dir: dump boxed JPEGs of the post-NMS detections of the first
        `debug_max_images` images (ref: eval_ron_network.py:240-247).
        loss_draws: with a RON `loss_config`, the loss's [2, B, N] draws of
        each batch, in order (else `batch_loss` seeds a generator per batch).

        Returns (map07, map12, {class: ap07}, stats); with `loss_config`,
        stats also holds each `loss/*` metric's mean over the batches, and
        `self.batch_losses` each batch's. `self.accumulator` keeps the run's
        per-class scores and TP/FP marks. Over a mesh, ranks other than 0
        return (None, None, {}, stats) and accumulate nothing."""
        acc = StreamingTpFp(self.spec.num_classes)
        self.accumulator = acc
        self.batch_losses = []
        n_images = 0
        n_debugged = 0
        t_start = time.time()

        def debug_dump(image_np, scores_np, boxes_np):
            """Boxed-JPEG dump of one batch's detections (host side)."""
            nonlocal n_debugged
            from ..utils.visualization import save_image_with_boxes

            for img in range(image_np.shape[0]):
                if n_debugged >= debug_max_images:
                    return
                if image_np.dtype == np.uint8:
                    img01 = image_np[img].astype(np.float32) / 255.0
                else:  # whitened floats -> [0, 1]
                    img01 = (image_np[img].astype(np.float32) + np.asarray(VGG_MEANS, np.float32)) / 255.0
                keep = scores_np[img] >= debug_score_threshold  # [C-1, K]
                cls_idx, det_idx = np.nonzero(keep)
                save_image_with_boxes(
                    img01,
                    boxes_np[img][cls_idx, det_idx],
                    cls_idx + 1,  # the class axis has no background
                    scores_np[img][cls_idx, det_idx],
                    directory=debug_dir,
                    index=n_debugged,
                )
                n_debugged += 1

        def dispatch(bi, batch):
            """Queue one batch on the device, and the copies of its results
            to the host behind it; returns without waiting, so the device
            runs this batch while the host harvests the one before."""
            image = torch.as_tensor(batch["image"])
            rows = None
            if self.mesh is not None:  # this data rank's rows of the global batch
                total = image.shape[0]
                if total % self.mesh.data_size:
                    raise ValueError(f"eval batch of {total} does not divide over {self.mesh.data_size} data ranks")
                b = total // self.mesh.data_size
                rows = (self.mesh.data_index * b, total)
                image = image[rows[0]: rows[0] + b]
            image = image.to(self.device)
            if image.dtype == torch.uint8:
                # uint8 transport (4x less host -> device traffic): scale and
                # whiten on the device
                image = whiten(image.to(torch.float32) / 255.0)
            gt = [torch.as_tensor(batch[k]).to(self.device) for k in ("gt_labels", "gt_boxes", "gt_difficult")]
            losses = {}
            if self._loss is None:
                scores, boxes = self.detector(image)
            else:  # one forward for the detections and the losses
                out = self.detector.model(image)
                scores, boxes = self.detector.postprocess(out)
                local_gt = gt if rows is None else [g[rows[0]: rows[0] + image.shape[0]] for g in gt]
                losses = self.batch_loss(out, local_gt[0], local_gt[1], bi,
                                         None if loss_draws is None else loss_draws[bi], rows=rows)
            if self.mesh is not None:  # the whole batch's detections, in row order
                scores, boxes = (all_gather_rows(t, self.mesh.data_group) for t in (scores, boxes))
            if not self.primary:
                return bi, None, list(losses), None, None
            res = match_all_classes(self.spec.num_classes, scores, boxes, *gt, self.matching_threshold)
            debug = debug_dir is not None and n_debugged < debug_max_images
            copied = copy_to_host(scores, res.n_gt, res.tp, res.fp, *losses.values(), *((boxes,) if debug else ()))
            sample_valid = batch.get("sample_valid")
            debug_image = np.asarray(batch["image"]) if debug else None
            return bi, copied, list(losses), sample_valid, debug_image

        def harvest(pending):
            """Take one dispatched batch's results and accumulate TP/FP."""
            nonlocal n_images
            bi, copied, loss_names, sample_valid, debug_image = pending
            if copied is None:  # a rank other than 0 of a mesh
                return
            scores, n_gt, tp, fp, *rest = wait_host(copied)
            if loss_names:
                self.batch_losses.append({k: float(v) for k, v in zip(loss_names, rest)})
            if debug_image is not None:
                debug_dump(debug_image, scores, rest[len(loss_names)])
            b = scores.shape[0]
            sample_valid = np.ones((b,), bool) if sample_valid is None else np.asarray(sample_valid)
            for img in range(b):
                if not sample_valid[img]:
                    continue  # padding row of a final short batch
                for c in range(1, self.spec.num_classes):
                    acc.add(c, n_gt[img, c - 1], scores[img, c - 1], tp[img, c - 1], fp[img, c - 1])
            n_images += int(sample_valid.sum())
            if log_every and (bi + 1) % log_every == 0:
                dt = time.time() - t_start
                print(f"[eval] {n_images} images, {dt / n_images:.3f} sec/image")

        # one-deep software pipeline: dispatch batch i, then harvest batch i-1
        pending = None
        for bi, batch in enumerate(batches):
            if max_batches is not None and bi >= max_batches:
                break
            current = dispatch(bi, batch)
            if pending is not None:
                harvest(pending)
            pending = current
        if pending is not None:
            harvest(pending)

        stats = {"images": n_images, "sec_per_image": (time.time() - t_start) / max(n_images, 1)}
        if not self.primary:
            return None, None, {}, stats
        map07, aps07 = acc.mean_average_precision("voc07")
        map12, _ = acc.mean_average_precision("voc12")
        for k in self.batch_losses[0] if self.batch_losses else ():
            stats[k] = sum(b[k] for b in self.batch_losses) / len(self.batch_losses)
        return map07, map12, aps07, stats
