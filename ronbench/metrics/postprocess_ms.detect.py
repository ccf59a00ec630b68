"""Mean ms a call spends in the head's postprocess: decode, gates, top-k and NMS (CUDA events
from the forward's end to the head's return)."""

from ronbench.readers import entry, span_ms


def read(ctx):
    return span_ms(ctx, "model_end", "call_end") if entry(ctx) == "detect" else None
