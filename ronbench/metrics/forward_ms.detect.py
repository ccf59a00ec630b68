"""Mean ms a call spends in the model's forward (CUDA events around the head's call of its model)."""

from ronbench.readers import entry, span_ms


def read(ctx):
    return span_ms(ctx, "model_start", "model_end") if entry(ctx) == "detect" else None
