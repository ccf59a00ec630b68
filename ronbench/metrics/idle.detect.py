"""% of the profiled window in which no kernel or copy ran on the card."""

from ronbench.readers import entry, idle


def read(ctx):
    return idle(ctx) if entry(ctx) == "detect" else None
