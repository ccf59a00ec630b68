"""A rolling step timer (sec/step, images/s).

A copy of `StepTimer` from `ron_tensorflow_tpu/utils/profiling.py`. The
card queues work asynchronously, so over a window the ticks measure the
rate at which steps complete only where the loop waits for the card now and
then (the trainer reads the loss at each log step).
"""

from __future__ import annotations

import time
from collections import deque
from typing import Optional


class StepTimer:
    """Rolling sec/step + images/sec."""

    def __init__(self, window: int = 50):
        self._times = deque(maxlen=window)
        self._last: Optional[float] = None

    def tick(self) -> None:
        now = time.perf_counter()
        if self._last is not None:
            self._times.append(now - self._last)
        self._last = now

    @property
    def sec_per_step(self) -> float:
        return sum(self._times) / len(self._times) if self._times else 0.0

    def images_per_sec(self, batch_size: int) -> float:
        s = self.sec_per_step
        return batch_size / s if s > 0 else 0.0
