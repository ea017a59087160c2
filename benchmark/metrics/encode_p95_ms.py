"""encode_p95_ms: the 95th percentile of every window request's latency,
failed ones included (host clock, dispatch to a complete answer)."""
import statistics


def read(ctx):
    lat = ctx.window.latencies_s
    if len(lat) < 2:
        return None
    return statistics.quantiles(lat, n=20, method="inclusive")[18] * 1e3
