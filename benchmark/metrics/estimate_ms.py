"""estimate_ms: the written-slot estimates, the ops launched under
`decode_v3.initial_w_scan` (round 1) and `decode_v3._anchored_w` (the
rebuild before a later round, absent where one round converges), device
ms a frame in the traced stretch."""
SPANS = ("qoi_tpu_torch.models.decode_v3.initial_w_scan",
         "qoi_tpu_torch.models.decode_v3._anchored_w")


def read(ctx):
    t = ctx.trace
    if t is None or any(s not in t.installed for s in SPANS):
        return None
    parts = [t.span_ms(s) for s in SPANS]
    if parts[0] is None:
        return None
    return sum(p for p in parts if p is not None)
