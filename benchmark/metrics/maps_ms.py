"""maps_ms: pass 1 of every fixpoint round (the meta plane and
`block_maps`), the device ms a request of the ops launched under the
program's span `qoi.decode.maps` in the traced stretch."""
from benchmark import program_spans

SPANS = ()
PROGRAM_SPANS = ("qoi.decode.maps",)


def read(ctx):
    t = ctx.trace
    return None if t is None else program_spans.device_ms(t, PROGRAM_SPANS[0])
