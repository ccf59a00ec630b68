"""% of K-A's bound (the keep mask's bytes at 3.35 TB/s or the overlaps these inputs need at
67 TFLOP/s f32, as counted on the compared calls' rows) over the mean device time of its launches."""

from ronbench.readers import KA, entry, roofline


def read(ctx):
    return roofline(ctx, "nms_bound_ms", KA) if entry(ctx) == "detect" else None
