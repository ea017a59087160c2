"""roofline_pct.encode: the least time of the traced stretch's requests at
the HBM rate (bytes: 4 a pixel and the stream's real bytes, each counted
once) over the device's busy time in the stretch, in %."""
from benchmark.harness import HBM_BYTES_PER_S


def read(ctx):
    t = ctx.trace
    if t is None or t.busy_s <= 0 or ctx.stretch_bytes <= 0:
        return None
    return ctx.stretch_bytes / HBM_BYTES_PER_S / t.busy_s * 100
