"""Seconds from process start to the first timed call: imports, the kernel library's load (its
nvcc build on a checkout's first run), weights, scenes and the warm-up of the cell's one shape."""


def read(ctx):
    return ctx.setup_s
