"""The 95th percentile of all requests' latencies in the window (host
clock, each request ending in a synchronize)."""

import statistics


def read(ctx):
    lat = ctx.window.latencies_s
    if len(lat) < 2:
        return None
    return statistics.quantiles(lat, n=100, method="inclusive")[94] * 1e3
