"""Profiling: traces of the enclosed steps and a rolling step timer.

Port of `ron_tensorflow_tpu/utils/profiling.py`. `profile_trace` records
with `torch.profiler` where JAX's records with `jax.profiler`, and writes a
Chrome/Perfetto trace (`tensorboard_trace_handler`'s layout,
`<host>_<pid>.<ms>.pt.trace.json`) under its `logdir` when the block
exits, viewable in Perfetto, chrome://tracing or TensorBoard's profiler
plugin. `StepTimer` is a copy: the card queues work asynchronously, so over
a window the ticks measure the rate at which steps complete only where the
loop waits for the card now and then (the trainer reads the loss at each
log step).
"""

from __future__ import annotations

import contextlib
import time
from collections import deque
from typing import Optional


@contextlib.contextmanager
def profile_trace(logdir: str, enabled: bool = True, device="cuda"):
    """Record a torch.profiler trace of the enclosed steps into `logdir`:
    host (CPU) activity, and the card's kernels and copies when `device` is
    a CUDA device. Asking for CUDA where there is no card raises (it never
    quietly records the host alone). With `enabled=False` it records and
    writes nothing."""
    if not enabled:
        yield
        return
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    from .. import resolve_device

    activities = [ProfilerActivity.CPU]
    if resolve_device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(logdir)):
        yield


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
