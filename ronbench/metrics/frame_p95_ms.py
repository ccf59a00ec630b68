"""95th percentile of every call of the window, each from handing over the host frames to its
detections on the host (host clock)."""

import statistics

from ronbench.readers import entry


def read(ctx):
    lat = ctx.counters.get("latencies_ms")
    if entry(ctx) != "realtime" or not lat:
        return None
    return statistics.quantiles(lat, n=20, method="inclusive")[18]
