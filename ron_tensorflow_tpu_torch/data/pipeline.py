"""Input pipeline: TFRecord shards -> fixed-size host batches, and their
upload to the card.

Port of `ron_tensorflow_tpu/data/pipeline.py`. `PipelineConfig`,
`parse_voc_example`, `_apply_difficult_policy`, `_pad_gt`,
`iterate_samples` and `batch_iterator` are copies (the same sample order
from `np.random.default_rng(seed + worker_index)`, the same padding of a
short final batch with `sample_valid`), with two differences: JPEGs decode
through the package's own decoder (`data/decode.py`), and a record without
`image/shape` takes its size from the JPEG header (`data/jpeg.py`) where
the JAX package opens PIL (pipeline.py:277). `PipelineConfig` takes JAX's
`prefetch`, which nothing reads, in the port as in the JAX package, and
`grain_workers`, which sizes the decode threads of the Grain-equivalent
pipeline (`grain_pipeline.GrainBatches`); `decode_jpeg_raw` is
`data/decode.py`'s. The host work
is IO, JPEG decode and one resize to the working canvas; the augmentation
runs on the device in the train step. `PrefetchIterator` is a copy of
`pipeline.py:317`.

`DevicePrefetcher` (`pipeline.py:350`) uploads one batch ahead on a
background thread: from pinned host memory, `non_blocking`, on a side CUDA
stream. The consumer's stream waits on the copy's event before it reads the
batch, and each tensor is recorded on the consumer's stream, so that the
caching allocator does not hand its memory to the next copy while the step
still reads it.

Difficult-object handling matches the trainer: difficult gts are dropped
unless every object is difficult, in which case all are kept
(ref: ron_net.py:241-244).
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, List, Optional

import numpy as np
import torch

from . import example as pb
from .decode import decode_jpeg, decode_jpeg_eval, decode_jpeg_raw  # noqa: F401  (decode_jpeg_raw: JAX's name here)
from .jpeg import jpeg_size
from .resize import remap_boxes_for_eval
from .tfrecord import read_records, shard_for_worker


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    batch_size: int = 32
    working_shape: tuple = (512, 512)  # host canvas fed to device augmentation
    max_boxes: int = 56
    shuffle: bool = True
    shuffle_buffer: int = 512
    prefetch: int = 4  # read by nothing, as in the JAX package (PrefetchIterator has its own depth)
    keep_difficult: bool = False  # training drops difficult (with fallback)
    num_workers: int = 1
    worker_index: int = 0
    seed: int = 0
    # cache decoded + resized images (uint8) in host RAM after the first epoch
    cache_decoded: bool = False
    # 'float32' or 'uint8' (a quarter of the upload; the consumer converts on the device)
    output_dtype: str = "float32"
    # eval resize strategy (ref: ssd_vgg_preprocessing.py:358-425): None = the
    # train path's bilinear warp to the working canvas; else TF1 legacy
    # bilinear numerics (data/resize.py), gt boxes remapped for CENTRAL_CROP /
    # PAD_AND_RESIZE. 'NONE' cannot be batched (variable shapes).
    eval_resize: Optional[str] = None
    # JPEG-decode threads per batch (ref: ron_net.py:300, 24 preprocessing
    # threads); the decoder releases the GIL; order-preserving and equal to
    # serial. -1 = auto (min(8, cpu_count - 1)); 0/1 = serial.
    decode_workers: int = -1
    # decode threads of the Grain-equivalent pipeline when > 0 (where JAX
    # runs grain child processes); order-preserving: the batches are the
    # same for any value
    grain_workers: int = 0


def parse_voc_example(record: bytes) -> Dict:
    """Serialized Example -> dict of numpy GT + raw JPEG bytes."""
    ex = pb.decode_example(record)
    n = len(ex.get("image/object/bbox/label", []))
    boxes = np.zeros((n, 4), np.float32)
    if n:
        boxes[:, 0] = ex["image/object/bbox/ymin"]
        boxes[:, 1] = ex["image/object/bbox/xmin"]
        boxes[:, 2] = ex["image/object/bbox/ymax"]
        boxes[:, 3] = ex["image/object/bbox/xmax"]
    return {
        "jpeg": ex["image/encoded"][0],
        "shape": tuple(ex.get("image/shape", (0, 0, 3))),
        "labels": np.asarray(ex.get("image/object/bbox/label", []), np.int32),
        "boxes": boxes,
        "difficult": np.asarray(ex.get("image/object/bbox/difficult", [0] * n), np.int32),
        "truncated": np.asarray(ex.get("image/object/bbox/truncated", [0] * n), np.int32),
    }


def _apply_difficult_policy(sample: Dict, keep_difficult: bool) -> Dict:
    if keep_difficult or sample["labels"].size == 0:
        return sample
    mask = sample["difficult"] == 0
    if not mask.any():  # all difficult -> keep everything (ref: ron_net.py:241-244)
        return sample
    return {
        **sample,
        "labels": sample["labels"][mask],
        "boxes": sample["boxes"][mask],
        "difficult": sample["difficult"][mask],
        "truncated": sample["truncated"][mask],
    }


def _pad_gt(sample: Dict, max_boxes: int) -> Dict:
    n = min(sample["labels"].size, max_boxes)
    labels = np.zeros((max_boxes,), np.int32)
    boxes = np.zeros((max_boxes, 4), np.float32)
    difficult = np.zeros((max_boxes,), np.int32)
    valid = np.zeros((max_boxes,), bool)
    labels[:n] = sample["labels"][:n]
    boxes[:n] = sample["boxes"][:n]
    difficult[:n] = sample["difficult"][:n]
    valid[:n] = True
    return {"labels": labels, "boxes": boxes, "difficult": difficult, "valid": valid}


def iterate_samples(files: List[str], config: PipelineConfig, epochs: Optional[int] = None) -> Iterator[Dict]:
    """Stream parsed samples from shards (shuffled per epoch)."""
    rng = np.random.default_rng(config.seed + config.worker_index)
    files = shard_for_worker(files, config.num_workers, config.worker_index)
    if not files:
        raise ValueError("no input shards for this worker")
    epoch = 0
    while epochs is None or epoch < epochs:
        order = list(files)
        if config.shuffle:
            rng.shuffle(order)
        buf: List[Dict] = []
        for path in order:
            for record in read_records(path):
                sample = _apply_difficult_policy(parse_voc_example(record), config.keep_difficult)
                if config.shuffle:
                    buf.append(sample)
                    if len(buf) >= config.shuffle_buffer:
                        idx = rng.integers(len(buf))
                        buf[idx], buf[-1] = buf[-1], buf[idx]
                        yield buf.pop()
                else:
                    yield sample
        while buf:
            idx = rng.integers(len(buf))
            buf[idx], buf[-1] = buf[-1], buf[idx]
            yield buf.pop()
        epoch += 1


def batch_iterator(
    files: List[str],
    config: PipelineConfig,
    epochs: Optional[int] = None,
    drop_remainder: bool = True,
) -> Iterator[Dict[str, np.ndarray]]:
    """Fixed-size host batches: image01 [B, H0, W0, 3] float (or uint8 per
    config.output_dtype), gt_labels [B, G], gt_boxes [B, G, 4], gt_valid
    [B, G], gt_difficult [B, G], sample_valid [B].

    With drop_remainder=False the final short batch is zero-padded to full
    size and `sample_valid` marks the real rows: evaluation covers every
    image (the reference scores all 4952 VOC07 test images)."""
    if config.eval_resize == "NONE":
        raise ValueError("eval_resize='NONE' yields variable shapes and cannot be batched; "
                         "use the realtime evaluator for it")
    it = iterate_samples(files, config, epochs)
    cache: Dict[bytes, np.ndarray] = {}

    def _decode(data: bytes) -> np.ndarray:
        if config.eval_resize:
            return decode_jpeg_eval(data, config.working_shape, config.eval_resize)
        return (decode_jpeg(data, config.working_shape) * 255.0 + 0.5).astype(np.uint8)

    def decode(data: bytes) -> np.ndarray:
        """The uint8 working canvas (cached by content hash)."""
        if not config.cache_decoded:
            return _decode(data)
        key = hashlib.blake2b(data, digest_size=16).digest()
        hit = cache.get(key)
        if hit is None:
            hit = _decode(data)
            cache[key] = hit
        return hit

    if config.decode_workers == -1:
        n_workers = max(1, min(8, (os.cpu_count() or 2) - 1))
    else:
        n_workers = max(1, config.decode_workers)
    pool = ThreadPoolExecutor(max_workers=n_workers, thread_name_prefix="decode") if n_workers > 1 else None

    exhausted = False
    try:
        while not exhausted:
            samples: List[Dict] = []
            try:
                for _ in range(config.batch_size):
                    samples.append(next(it))
            except StopIteration:
                exhausted = True
                if not samples or drop_remainder:
                    return
            # the whole batch in the thread pool: order-preserving, equal to serial
            if pool is not None:
                images = list(pool.map(decode, (s["jpeg"] for s in samples)))
            else:
                images = [decode(s["jpeg"]) for s in samples]
            labels, boxes, valid, difficult = [], [], [], []
            for s in samples:
                if config.eval_resize in ("CENTRAL_CROP", "PAD_AND_RESIZE"):
                    h0, w0 = s["shape"][:2]
                    if not (h0 and w0):  # shape absent from the record
                        h0, w0 = jpeg_size(s["jpeg"])
                    s = {**s, "boxes": remap_boxes_for_eval(s["boxes"], (h0, w0), config.eval_resize,
                                                            config.working_shape)}
                gt = _pad_gt(s, config.max_boxes)
                labels.append(gt["labels"])
                boxes.append(gt["boxes"])
                valid.append(gt["valid"])
                difficult.append(gt["difficult"])
            n_real = len(images)
            pad = config.batch_size - n_real
            if pad:
                images += [np.zeros_like(images[0])] * pad
                labels += [np.zeros_like(labels[0])] * pad
                boxes += [np.zeros_like(boxes[0])] * pad
                valid += [np.zeros_like(valid[0])] * pad
                difficult += [np.zeros_like(difficult[0])] * pad
            stacked = np.stack(images)  # uint8 from decode()
            if config.output_dtype != "uint8":
                stacked = stacked.astype(np.float32) / 255.0
            sample_valid = np.zeros((config.batch_size,), bool)
            sample_valid[:n_real] = True
            yield {
                "image01": stacked,
                "gt_labels": np.stack(labels),
                "gt_boxes": np.stack(boxes),
                "gt_valid": np.stack(valid),
                "gt_difficult": np.stack(difficult),
                "sample_valid": sample_valid,
            }
    finally:
        if pool is not None:
            pool.shutdown(wait=False)


class PrefetchIterator:
    """Background-thread prefetch of host batches (the queue-runner
    replacement)."""

    _SENTINEL = object()

    def __init__(self, iterator: Iterator, depth: int = 4):
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._thread = threading.Thread(target=self._fill, args=(iterator,), daemon=True)
        self._err: Optional[BaseException] = None
        self._thread.start()

    def _fill(self, iterator):
        try:
            for item in iterator:
                self._q.put(item)
        except BaseException as e:  # surfaced on the consumer side
            self._err = e
        finally:
            self._q.put(self._SENTINEL)

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is self._SENTINEL:
            if self._err is not None:
                raise self._err
            raise StopIteration
        return item


def to_device(host_batch: Dict, device, non_blocking: bool = False) -> Dict[str, torch.Tensor]:
    """Numpy arrays or tensors -> tensors on `device`; on a CUDA device each
    goes through pinned memory, asynchronously when `non_blocking`."""
    device = torch.device(device)
    out = {}
    for k, v in host_batch.items():
        t = torch.as_tensor(np.asarray(v)) if not torch.is_tensor(v) else v
        if device.type == "cuda" and t.device.type == "cpu":
            t = t.pin_memory()
        out[k] = t.to(device, non_blocking=non_blocking)
    return out


class DevicePrefetcher:
    """Uploads host batches to `device` one batch ahead on a background
    thread, so that the copy of batch N+1 overlaps the step on batch N.

    On a CUDA device the copies run on a side stream; `__next__` makes the
    current stream wait for the batch's copy to finish and records its
    tensors on that stream. On the CPU it only converts."""

    _SENTINEL = object()

    def __init__(self, iterator: Iterator, device, depth: int = 2):
        self.device = torch.device(device)
        self._stream = torch.cuda.Stream(self.device) if self.device.type == "cuda" else None
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._err: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._fill, args=(iterator,), daemon=True)
        self._thread.start()

    def _place(self, host_batch):
        if self._stream is None:
            return to_device(host_batch, self.device), None
        with torch.cuda.stream(self._stream):
            batch = to_device(host_batch, self.device, non_blocking=True)
            done = torch.cuda.Event()
            done.record(self._stream)
        return batch, done

    def _fill(self, iterator):
        try:
            for item in iterator:
                self._q.put(self._place(item))
        except BaseException as e:  # surfaced on the consumer side
            self._err = e
        finally:
            self._q.put(self._SENTINEL)

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is self._SENTINEL:
            if self._err is not None:
                raise self._err
            raise StopIteration
        batch, done = item
        if done is not None:
            current = torch.cuda.current_stream(self.device)
            current.wait_event(done)
            for t in batch.values():
                t.record_stream(current)
        return batch
