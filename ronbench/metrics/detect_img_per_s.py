"""Images whose detections reached the host in the window, over the window's seconds (host clock)."""

from ronbench.readers import entry


def read(ctx):
    if entry(ctx) != "detect":
        return None
    return ctx.counters["images"] / ctx.counters["window_s"]
