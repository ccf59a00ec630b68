"""Host-side batch prefetch, and the upload of host batches to the card.

`PrefetchIterator` is a copy of `ron_tensorflow_tpu/data/pipeline.py:317`.
`DevicePrefetcher` (`pipeline.py:350`) uploads one batch ahead on a
background thread: from pinned host memory, `non_blocking`, on a side CUDA
stream. The consumer's stream waits on the copy's event before it reads the
batch, and each tensor is recorded on the consumer's stream, so that the
caching allocator does not hand its memory to the next copy while the step
still reads it. Reading TFRecord shards (`batch_iterator`)
waits for the data slice.
"""

from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator, Optional

import numpy as np
import torch


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
