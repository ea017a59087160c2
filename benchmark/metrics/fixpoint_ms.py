"""fixpoint_ms: the decode fixpoint's self time, the ops launched under
`decode_v3._decode_core` less those under its layers 4-5 (`_fields`,
`initial_w_scan`, `_anchored_w`), device ms a frame in the traced
stretch. A child that never ran in the stretch counts 0; one that is not
installed leaves the metric unread."""
CORE = "qoi_tpu_torch.models.decode_v3._decode_core"
PARTS = ("qoi_tpu_torch.models.decode_v3._fields",
         "qoi_tpu_torch.models.decode_v3.initial_w_scan",
         "qoi_tpu_torch.models.decode_v3._anchored_w")
SPANS = (CORE, *PARTS)


def read(ctx):
    t = ctx.trace
    if t is None or any(s not in t.installed for s in SPANS):
        return None
    core = t.span_ms(CORE)
    if core is None:
        return None
    return core - sum(t.span_ms(p) or 0.0 for p in PARTS)
