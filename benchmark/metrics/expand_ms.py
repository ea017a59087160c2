"""expand_ms: decode expand, the ops launched under
`decode_v3._expand_packed`, device ms a frame in the traced stretch."""
SPANS = ("qoi_tpu_torch.models.decode_v3._expand_packed",)


def read(ctx):
    return None if ctx.trace is None else ctx.trace.span_ms(SPANS[0])
