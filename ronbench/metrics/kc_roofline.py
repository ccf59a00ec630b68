"""% of K-C's bound (as K-A's, with the dividing test and the cap) over the mean device time of its
launches in the profiled window."""

from ronbench.readers import KC, entry, roofline


def read(ctx):
    return roofline(ctx, "nms_bound_ms", KC) if entry(ctx) == "realtime" else None
