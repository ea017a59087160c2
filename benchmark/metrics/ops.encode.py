"""ops.encode: the device ops (kernels, copies, memsets; hand-written and
PyTorch's alike) a request launched under the program's span `qoi.encode`,
in the traced stretch."""
from benchmark import program_spans

SPANS = ()
PROGRAM_SPANS = ("qoi.encode",)


def read(ctx):
    t = ctx.trace
    return None if t is None else program_spans.op_count(t, PROGRAM_SPANS[0])
