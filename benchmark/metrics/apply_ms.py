"""apply_ms: pass 3 of every fixpoint round (`_apply_symbolic`), the
device ms a request of the ops launched under the program's span
`qoi.decode.apply` in the traced stretch."""
from benchmark import program_spans

SPANS = ()
PROGRAM_SPANS = ("qoi.decode.apply",)


def read(ctx):
    t = ctx.trace
    return None if t is None else program_spans.device_ms(t, PROGRAM_SPANS[0])
