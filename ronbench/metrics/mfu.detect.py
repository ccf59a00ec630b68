"""% of the bf16 peak (989 TFLOP/s) that the model's forward operations of the traced window's images
make over its seconds."""

from ronbench.readers import entry, mfu


def read(ctx):
    return mfu(ctx) if entry(ctx) == "detect" else None
