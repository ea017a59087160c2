"""stage_ms: encode staging, the ops launched under
`pipeline.encode_stage_chunks`, device ms a frame in the traced stretch."""
SPANS = ("qoi_tpu_torch.models.pipeline.encode_stage_chunks",)


def read(ctx):
    return None if ctx.trace is None else ctx.trace.span_ms(SPANS[0])
