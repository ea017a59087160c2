"""certify_ms: the certificate of every fixpoint round (the mismatches and
their host read), the device ms a request of the ops launched under the
program's span `qoi.decode.certify` in the traced stretch."""
from benchmark import program_spans

SPANS = ()
PROGRAM_SPANS = ("qoi.decode.certify",)


def read(ctx):
    t = ctx.trace
    return None if t is None else program_spans.device_ms(t, PROGRAM_SPANS[0])
