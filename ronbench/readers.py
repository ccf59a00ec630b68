"""What the metric readers under `metrics/` share. Each returns None where
its cell has nothing to read, and the harness then leaves the metric out."""

from __future__ import annotations

import re
import statistics
from typing import Optional

from ronbench import counts

KA = r"nms_\w+_kernel<false, false"  # K-A: the keep mask without division and without a cap
KC = r"nms_\w+_kernel<true, true"  # K-C: dividing, capped
KB = r"fused_vgg_block1_kernel"  # K-B at VGG block 1


def entry(ctx) -> str:
    return ctx.plan.traffic["entry"]


def span_ms(ctx, a: str, b: str) -> Optional[float]:
    """Mean ms from each call's span point a to its point b (CUDA events)."""
    if ctx.spans is None:
        return None
    ms = ctx.spans.between(a, b)
    return statistics.fmean(ms) if ms else None


def kernel_ms(ctx, pattern: str) -> Optional[float]:
    """Mean device ms of the profiled launches whose name matches."""
    if not ctx.trace:
        return None
    times = [t for name, ts in ctx.trace["kernels"].items() if re.search(pattern, name) for t in ts]
    return statistics.fmean(times) * 1e3 if times else None


def roofline(ctx, bound_key: str, pattern: str) -> Optional[float]:
    """% of the least time (a bound of `counts`) over the mean launch's time."""
    ms = kernel_ms(ctx, pattern)
    if ms is None or bound_key not in ctx.counters:
        return None
    return 100.0 * ctx.counters[bound_key] / ms


def mfu(ctx) -> Optional[float]:
    """% of the bf16 peak: the model's operations for every image of the
    window over the window's seconds."""
    c = ctx.counters
    return 100.0 * c["flops_per_image"] * c["images"] / c["window_s"] / counts.PEAK_BF16_FLOPS


def idle(ctx) -> Optional[float]:
    """% of the profiled window in which no kernel or copy ran on the card."""
    if not ctx.trace or not ctx.trace["window_s"]:
        return None
    return 100.0 * (1.0 - ctx.trace["busy_s"] / ctx.trace["window_s"])
