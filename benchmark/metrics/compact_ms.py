"""compact_ms: encode compaction, the ops launched under
`compact.compact_words6_wordsum`, device ms a frame in the traced stretch."""
SPANS = ("qoi_tpu_torch.ops.compact.compact_words6_wordsum",)


def read(ctx):
    return None if ctx.trace is None else ctx.trace.span_ms(SPANS[0])
