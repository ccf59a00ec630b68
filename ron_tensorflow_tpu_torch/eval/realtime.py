"""Realtime evaluator, the `ron_eval` equivalent that produced the published
0.7+ mAP (ref: ron_eval.py:428-594).

Port of `ron_tensorflow_tpu/eval/realtime.py::RealtimeEvaluator`. It reads
images and XML straight from a VOCdevkit tree, runs the `RealtimeDetector`
(whole-image NMS through K-C) on batches of images, whitened on the
device, collects `all_boxes[cls][image] = (x1, y1, x2, y2, score)` in the
original frame's pixels with the reference's y/x swap
(ref: ron_eval.py:563-580), then runs the official offline VOC evaluation.
"""

from __future__ import annotations

import os
import pickle
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from ..data.preprocess import whiten
from ..inference.detector import RealtimeConfig, RealtimeDetector
from .evaluator import copy_to_host, wait_host
from .voc_eval import PascalVocEvaluator


class RealtimeEvaluator:
    def __init__(self, model, spec, config: RealtimeConfig = RealtimeConfig(), device="cuda"):
        self.detector = RealtimeDetector(model, spec, config, device=device)
        self.device = self.detector.device
        self.spec = spec

    def min_size(self, orig_shape) -> float:
        """The min-size filter scaled to an original frame (H0, W0)
        (ref: ron_eval.py:369-375, 471)."""
        h0, w0 = orig_shape
        net_h, net_w = self.spec.img_shape
        return self.detector.config.min_size * float(np.sqrt((h0 * w0) / (net_h * net_w)))

    @torch.inference_mode()
    def _detect01(self, images01, min_sizes):
        """[0, 1] images at the net's resolution -> the detector's outputs,
        whitened on the device."""
        x = torch.as_tensor(images01).to(self.device, torch.float32)
        return self.detector(whiten(x), min_sizes)

    def detect_image(self, image01: np.ndarray, orig_shape=None):
        """One decoded [H, W, 3] float [0, 1] image, already at the net's
        resolution -> {cls: [k, 5] float32 rows (x1, y1, x2, y2, score)} in
        its pixels. orig_shape (H0, W0) of the original frame scales the
        min-size filter."""
        h, w = image01.shape[:2]
        min_size = np.float32(self.min_size(orig_shape if orig_shape is not None else (h, w)))
        out = self._detect01(np.asarray(image01)[None], min_size)
        scores, labels, boxes, valid = wait_host(copy_to_host(*out))
        return self._to_per_class(scores[0], labels[0], boxes[0], valid[0], h, w)

    @staticmethod
    def _to_per_class(scores, labels, boxes, valid, h, w) -> Dict[int, np.ndarray]:
        out: Dict[int, List] = {}
        for i in range(len(scores)):
            if not valid[i]:
                continue
            ymin, xmin, ymax, xmax = boxes[i]
            # to pixels, with the axis swap (ref: ron_eval.py:563-580)
            out.setdefault(int(labels[i]), []).append([xmin * w, ymin * h, xmax * w, ymax * h, scores[i]])
        return {k: np.asarray(v, np.float32) for k, v in out.items()}

    def detect_batch(self, images01: np.ndarray, orig_shapes):
        """[B, Hn, Wn, 3] float [0, 1] images at the net's resolution, of
        mixed original frames -> a list of per-class pixel-box dicts. One
        batch on the device; the per-image min sizes ride along as a [B]
        vector (the reference ran one image per sess.run, ron_eval.py:539)."""
        h, w = images01.shape[1:3]
        return self._harvest_batch(self._dispatch_batch(images01, orig_shapes), h, w)

    def _dispatch_batch(self, images01: np.ndarray, orig_shapes):
        """The half of detect_batch that does not wait: queue one batch and
        the copies of its results to the host."""
        min_sizes = np.asarray([self.min_size(s) for s in orig_shapes], np.float32)
        return copy_to_host(*self._detect01(images01, min_sizes))

    def _harvest_batch(self, dispatched, h, w):
        """The waiting half: the results on the host, as per-class pixel-box
        dicts."""
        scores, labels, boxes, valid = wait_host(dispatched)
        return [
            self._to_per_class(scores[i], labels[i], boxes[i], valid[i], h, w)
            for i in range(scores.shape[0])
        ]

    def evaluate_voc(
        self,
        voc_root: str,
        set_type: str = "test",
        max_images: Optional[int] = None,
        output_dir: Optional[str] = None,
        use_07_metric: bool = True,
        batch_size: int = 8,
        decode_workers: int = 4,
        debug_dir: Optional[str] = None,
        debug_max_images: int = 64,
    ):
        """Full VOCdevkit evaluation (ref: ron_eval.py:529-594): a thread
        pool reads, decodes (JPEG or PNG, cv2's bits) and resizes (the decoders release the GIL)
        the next batch while the current one runs on the device; the last
        batch is padded to batch_size. Detections are rescaled to each
        original frame; with output_dir they are also pickled to
        `detections.pkl`. debug_dir: boxed JPEGs of the first
        `debug_max_images` images' detections (ref: ron_eval.py:553-555).

        Returns (mAP, {class: AP})."""
        from concurrent.futures import ThreadPoolExecutor

        from ..data.decode import decode_jpeg_raw
        from ..data.resize import tf1_bilinear_resize

        evaluator = PascalVocEvaluator(voc_root, set_type, output_dir)
        image_ids = evaluator.image_ids
        if max_images:
            image_ids = image_ids[:max_images]
            evaluator.image_ids = image_ids

        num_classes = self.spec.num_classes
        all_boxes = [[np.zeros((0, 5), np.float32) for _ in image_ids] for _ in range(num_classes)]
        nh, nw = self.spec.img_shape

        def load(image_id):
            path = os.path.join(evaluator.root, "JPEGImages", image_id + ".jpg")
            with open(path, "rb") as f:
                raw = decode_jpeg_raw(f.read())
            # TF1 legacy bilinear warp, the reference's preprocess_for_eval
            # numerics (ref: tf_image.py:269-281)
            img = tf1_bilinear_resize(raw, self.spec.img_shape) / 255.0
            return img.astype(np.float32), raw.shape[:2]

        groups = [image_ids[i : i + batch_size] for i in range(0, len(image_ids), batch_size)]
        t0 = time.time()
        n_done = 0

        def debug_dump(ii, image01, per_class):
            from ..utils.visualization import save_image_with_boxes

            rows_boxes, rows_labels, rows_scores = [], [], []
            for cls, rows in per_class.items():
                for x1, y1, x2, y2, s in rows:
                    rows_boxes.append([y1 / nh, x1 / nw, y2 / nh, x2 / nw])
                    rows_labels.append(cls)
                    rows_scores.append(s)
            save_image_with_boxes(
                image01,
                np.asarray(rows_boxes, np.float32).reshape(-1, 4),
                np.asarray(rows_labels, np.int32),
                np.asarray(rows_scores, np.float32),
                directory=debug_dir,
                index=ii,
            )

        def harvest(gi, ids, loaded, dispatched):
            """Take one dispatched batch and fill all_boxes, while the next
            batch runs on the device."""
            nonlocal n_done
            per_class_list = self._harvest_batch(dispatched, nh, nw)
            for k, image_id in enumerate(ids):
                ii = gi * batch_size + k
                h0, w0 = loaded[k][1]
                if debug_dir is not None and ii < debug_max_images:
                    debug_dump(ii, loaded[k][0], per_class_list[k])
                for cls, rows in per_class_list[k].items():
                    rows = rows.copy()
                    # from the net's pixels to the original frame's
                    rows[:, [0, 2]] *= w0 / nw
                    rows[:, [1, 3]] *= h0 / nh
                    all_boxes[cls][ii] = rows
            n_done += len(ids)
            if (gi + 1) % max(1, 100 // batch_size) == 0:
                print(f"[ron-eval] {n_done}/{len(image_ids)}  {(time.time() - t0) / n_done:.3f} sec/image")

        with ThreadPoolExecutor(max_workers=decode_workers) as pool:
            pending = [pool.submit(load, i) for i in groups[0]] if groups else []
            prev = None  # one-deep pipeline: (gi, ids, loaded, dispatched)
            for gi, ids in enumerate(groups):
                loaded = [f.result() for f in pending]
                if gi + 1 < len(groups):  # decode the next batch meanwhile
                    pending = [pool.submit(load, i) for i in groups[gi + 1]]
                images = np.stack([im for im, _ in loaded])
                shapes = [s for _, s in loaded]
                if len(ids) < batch_size:  # pad the final short batch
                    pad = batch_size - len(ids)
                    images = np.concatenate([images, np.zeros((pad, *images.shape[1:]), np.float32)])
                    shapes = shapes + [self.spec.img_shape] * pad
                dispatched = self._dispatch_batch(images, shapes)
                if prev is not None:
                    harvest(*prev)
                prev = (gi, ids, loaded, dispatched)
            if prev is not None:
                harvest(*prev)

        if output_dir:
            os.makedirs(output_dir, exist_ok=True)
            with open(os.path.join(output_dir, "detections.pkl"), "wb") as f:
                pickle.dump(all_boxes, f)
        return evaluator.evaluate(all_boxes, use_07_metric=use_07_metric)
