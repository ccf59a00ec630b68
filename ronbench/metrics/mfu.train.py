"""% of the bf16 peak (989 TFLOP/s) that three times the forward's operations of every image the window
trained on make over its seconds: the forward, and the backward's two products of each convolution."""

from ronbench.readers import entry, mfu


def read(ctx):
    return 3.0 * mfu(ctx) if entry(ctx) == "train" else None
