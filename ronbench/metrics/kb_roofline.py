"""% of K-B's bound (fused VGG block 1: its operations at 989 TFLOP/s or its bytes at 3.35 TB/s)
over the mean device time of its launches in the profiled window."""

from ronbench.readers import KB, roofline


def read(ctx):
    return roofline(ctx, "kb_bound_ms", KB)
