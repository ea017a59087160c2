"""compose_ms: pass 2 of every fixpoint round (`_compose_entry_states`),
the device ms a request of the ops launched under the program's span
`qoi.decode.compose` in the traced stretch."""
from benchmark import program_spans

SPANS = ()
PROGRAM_SPANS = ("qoi.decode.compose",)


def read(ctx):
    t = ctx.trace
    return None if t is None else program_spans.device_ms(t, PROGRAM_SPANS[0])
