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

The port's own tracer: named spans and counters inside the program's
stages (`inference/detector.py`, `train/`), read by `snapshot()`, the
trainer's log and the CLI's `--spans` table. `span(name, device)` costs a
flag test when nothing reads it. While a torch profiler runs it opens a
host range `ron.<name>` on the profiler's timeline, beside the card's
kernels and copies. The range is a function-scope record, not a user
annotation: the profiler draws no copy of it on the device's timeline, so
the card's busy and idle intervals read the same with the ranges as
without them. Once `enable()` is called, each span adds its host time
(`perf_counter_ns`) and, on a CUDA device, the time between two events on
the current stream. The events are never waited for inside a span: the
finished ones are read with `Event.query()` whenever `PENDING_LIMIT` pairs
wait, the rest at `snapshot()`. Each name keeps its calls, sums and
maxima, so the tracer's memory stays bounded over a run of any length.
`count(name, n)` adds to a counter while the tracer is enabled.
"""

from __future__ import annotations

import contextlib
import threading
import time
from collections import deque
from typing import Dict, List, Optional

import torch
import torch.autograd.profiler as _autograd_profiler


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


# --------------------------------------------------------------------------- #
# Spans and counters

RANGE_PREFIX = "ron."  # the profiler ranges' names: "ron." + the span's
PENDING_LIMIT = 256  # event pairs held before the finished ones are read
_FREE_LIMIT = 512  # events kept for reuse

_enabled = False
_lock = threading.Lock()
_spans: Dict[str, List[float]] = {}  # name -> [calls, host ns, host max ns, device calls, device ms, device max ms]
_counters: Dict[str, int] = {}
_pending: List[tuple] = []  # (name, device index, start event, end event), in the order they were recorded
_free: Dict[int, List[torch.cuda.Event]] = {}  # by device: an event records on its own device only


class _NullSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NULL_SPAN = _NullSpan()


def _range(name: str):
    """The profiler's host range `ron.<name>`, a function-scope record."""
    from torch._C._profiler import _RecordFunctionFast

    return _RecordFunctionFast(RANGE_PREFIX + name)


def _event(index: int) -> torch.cuda.Event:
    with _lock:
        free = _free.get(index)
        if free:
            return free.pop()
    return torch.cuda.Event(enable_timing=True)


def _add(name: str, host_ns: int = 0, device_ms: Optional[float] = None) -> None:
    """Fold one call's host time, or its device time, into `name`'s sums (under the lock)."""
    s = _spans.get(name)
    if s is None:
        s = _spans[name] = [0, 0, 0, 0, 0.0, 0.0]
    if device_ms is None:
        s[0] += 1
        s[1] += host_ns
        s[2] = max(s[2], host_ns)
    else:
        s[3] += 1
        s[4] += device_ms
        s[5] = max(s[5], device_ms)


def _drain(wait: bool) -> None:
    """Fold the pending event pairs that have finished (all of them when
    `wait`) into their spans (under the lock)."""
    left = []
    for pair in _pending:
        name, index, start, end = pair
        if wait:
            end.synchronize()
        elif not end.query():
            left.append(pair)
            continue
        _add(name, device_ms=start.elapsed_time(end))
        free = _free.setdefault(index, [])
        if len(free) < _FREE_LIMIT:
            free.extend((start, end))
    _pending[:] = left
    if len(_pending) >= PENDING_LIMIT:
        # the card runs a whole PENDING_LIMIT spans behind the host: wait for
        # the oldest, so that memory stays bounded
        name, _, start, end = _pending.pop(0)
        end.synchronize()
        _add(name, device_ms=start.elapsed_time(end))


class _Span:
    __slots__ = ("name", "device", "range", "stream", "start", "t0")

    def __init__(self, name: str, device):
        self.name, self.device = name, None if device is None else torch.device(device)

    def __enter__(self):
        self.range = _range(self.name) if _autograd_profiler._is_profiler_enabled else None
        if self.range is not None:
            self.range.__enter__()
        self.stream = self.start = None
        if self.device is not None and self.device.type == "cuda":
            self.stream = torch.cuda.current_stream(self.device)
            self.start = _event(self.stream.device_index)
            self.start.record(self.stream)
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        host_ns = time.perf_counter_ns() - self.t0
        end = None
        if self.stream is not None:
            end = _event(self.stream.device_index)
            end.record(self.stream)
        if self.range is not None:
            self.range.__exit__(*exc)
        with _lock:
            _add(self.name, host_ns)
            if end is not None:
                _pending.append((self.name, self.stream.device_index, self.start, end))
                if len(_pending) >= PENDING_LIMIT:
                    _drain(wait=False)
        return False


def span(name: str, device: Optional[torch.device] = None):
    """A context around one stage of the program: the shared no-op while
    the tracer is off and no profiler runs; the profiler's range
    `ron.<name>` while one runs; once `enable()` is called, the stage's
    host time and, for a CUDA `device`, its time on the current stream."""
    if _enabled:
        return _Span(name, device)
    if _autograd_profiler._is_profiler_enabled:
        return _range(name)
    return NULL_SPAN


def count(name: str, n: int) -> None:
    """Add `n` to the counter `name` while the tracer is enabled."""
    if _enabled:
        with _lock:
            _counters[name] = _counters.get(name, 0) + int(n)


def count_upload(name: str, source, placed: torch.Tensor) -> None:
    """Add `placed`'s bytes to the counter `name` unless `source`, of which
    `placed` is the copy on its device, was a tensor on that device
    already (then nothing crossed to it)."""
    if _enabled:
        count(name, 0 if torch.is_tensor(source) and source.device == placed.device else placed.nbytes)


def enabled() -> bool:
    return _enabled


def enable() -> None:
    global _enabled
    _enabled = True


def disable() -> None:
    """Stop recording; what was recorded stays readable by `snapshot()`."""
    global _enabled
    _enabled = False


def reset() -> None:
    """Forget every span, counter and pending event."""
    with _lock:
        _spans.clear()
        _counters.clear()
        _pending.clear()


def _calls_of(head: str) -> int:
    """Calls of the span that encloses the counters named `<head>.*`:
    `<head>.call`, else `<head>.step`."""
    for outer in (f"{head}.call", f"{head}.step"):
        if outer in _spans:
            return _spans[outer][0]
    return 0


def snapshot() -> dict:
    """{"spans": {name: {calls, host_ms, host_max_ms, device_ms,
    device_max_ms}}, "counters": {name: {total, per_call}}}: means over
    the calls; device times None for a span without CUDA events (the CPU);
    a counter's per-call mean over the calls of its enclosing span
    (`<head>.call` or `<head>.step` for a counter `<head>.<what>`), None
    without one. Waits for the pending events."""
    with _lock:
        _drain(wait=True)
        spans = {}
        for name, (calls, host, host_max, dev_calls, dev, dev_max) in sorted(_spans.items()):
            spans[name] = {"calls": calls, "host_ms": host / calls / 1e6,
                           "host_max_ms": host_max / 1e6,
                           "device_ms": dev / dev_calls if dev_calls else None,
                           "device_max_ms": dev_max if dev_calls else None}
        counters = {}
        for name, total in sorted(_counters.items()):
            calls = _calls_of(name.split(".")[0])
            counters[name] = {"total": total, "per_call": total / calls if calls else None}
    return {"spans": spans, "counters": counters}


def since(before: dict, after: dict) -> Dict[str, dict]:
    """Each span's mean host and device ms over the calls made between two
    snapshots: {name: {"host_ms", "device_ms"}} (device None without
    device times), for the spans called in between."""
    out = {}
    for name, a in after["spans"].items():
        b = before["spans"].get(name, {"calls": 0, "host_ms": 0.0, "device_ms": 0.0})
        n = a["calls"] - b["calls"]
        if n <= 0:
            continue
        total = lambda s, key: (s[key] or 0.0) * s["calls"]  # noqa: E731
        out[name] = {"host_ms": (total(a, "host_ms") - total(b, "host_ms")) / n,
                     "device_ms": None if a["device_ms"] is None
                     else (total(a, "device_ms") - total(b, "device_ms")) / n}
    return out


def format_snapshot(snap: dict) -> str:
    """`snapshot()` as a table: a line a span, then a line a counter."""
    lines = [f"{'span':<22} {'calls':>8} {'host ms':>10} {'max':>10} {'device ms':>10} {'max':>10}"]
    fmt = lambda v: f"{v:10.4f}" if v is not None else f"{'-':>10}"  # noqa: E731
    for name, s in snap["spans"].items():
        lines.append(f"{name:<22} {s['calls']:>8} {fmt(s['host_ms'])} {fmt(s['host_max_ms'])} "
                     f"{fmt(s['device_ms'])} {fmt(s['device_max_ms'])}")
    if snap["counters"]:
        lines.append(f"{'counter':<22} {'total':>19} {'a call':>21}")
        for name, c in snap["counters"].items():
            per = f"{c['per_call']:21.1f}" if c["per_call"] is not None else f"{'-':>21}"
            lines.append(f"{name:<22} {c['total']:>19} {per}")
    return "\n".join(lines)
