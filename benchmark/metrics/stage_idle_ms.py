"""stage_idle_ms: the ms a request in which the device was idle while the
host was inside the program's span `qoi.encode.stage_chunks` (its wrapper
before the staging kernel starts), in the traced stretch. The profiler
slows the host, so this reads higher than the untraced idle that
`idle_pct.encode` derives: compare it parent against change, both
traced."""
from benchmark import program_spans

SPANS = ()
PROGRAM_SPANS = ("qoi.encode.stage_chunks",)


def read(ctx):
    t = ctx.trace
    return None if t is None else program_spans.idle_ms(t, PROGRAM_SPANS[0])
