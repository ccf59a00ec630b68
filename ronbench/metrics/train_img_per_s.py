"""Images of every training step completed in the window (it ends on the wait for the last step),
over the window's seconds (host clock)."""

from ronbench.readers import entry


def read(ctx):
    if entry(ctx) != "train":
        return None
    return ctx.counters["images"] / ctx.counters["window_s"]
