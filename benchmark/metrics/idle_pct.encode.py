"""idle_pct.encode: the share of the window's untraced time in which no
kernel, copy or memset ran on the device, in %: the traced stretch's busy
time a request over the host time a request outside the stretch (the
profiler slows the host, so the stretch's own idle share, which the
result's `busy_s` and `window_s` give, reads high)."""
from benchmark.harness import untraced_idle_pct


def read(ctx):
    return untraced_idle_pct(ctx)
