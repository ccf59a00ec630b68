"""Mean ms from the call's start to its model's start: the host frames' copy to the card
(pageable) inside `RealtimeDetector` (CUDA events)."""

from ronbench.readers import entry, span_ms


def read(ctx):
    return span_ms(ctx, "call_start", "model_start") if entry(ctx) == "realtime" else None
