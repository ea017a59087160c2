"""The program's own spans in a traced stretch.

The port names its layers with `utils/profiling.annotate` spans
(`qoi.encode`, `qoi.decode` and the layers inside them), record_function
ranges that torch.profiler writes as `user_annotation` events into the
same trace as the device ops. The readers here take them from a
`tracing.TraceView`: the host events of the stretch's thread
(`view.host`) and the device ops (`view.ops`, each with the time and
thread of the host call that launched it). No wrapper is installed for
them: a metric that reads them declares `SPANS = ()`, and names the
program spans it reads in `PROGRAM_SPANS`.

- device time and ops count for a span when the op's launch lies inside
  one of the span's ranges on the stretch's thread (inclusive: a span's
  ops include those of the spans nested in it);
- idle time counts for a span when the middle of an idle gap of the
  stretch lies inside one of its ranges (the rule of
  `TraceView.idle_gaps`);
- every value is per request: over the view's `frames`.

A span absent from the stretch reads None, and its metric is left out:
the program lacks it (an older commit, or a span renamed).
"""
from __future__ import annotations

import bisect
from typing import List, Optional, Tuple

from benchmark.tracing import TraceView, _union


def ranges(view: TraceView, name: str) -> List[Tuple[float, float]]:
    """The union of the span `name`'s ranges on the stretch's thread, in
    trace microseconds, sorted."""
    return _union([(a, b) for a, b, n in view.host if n == name])


def _inside(rs: List[Tuple[float, float]], ts: float) -> bool:
    i = bisect.bisect_right(rs, (ts, float("inf"))) - 1
    return i >= 0 and rs[i][0] <= ts < rs[i][1]


def _launched(view: TraceView, name: str):
    """The device ops launched inside the span on the stretch's thread,
    or None where the span or the device ops are absent."""
    rs = ranges(view, name)
    if not rs or not view.ops or view.frames <= 0:
        return None
    return [op for op in view.ops
            if op[3] is not None and op[4] == view.main_tid
            and _inside(rs, op[3])]


def device_ms(view: TraceView, name: str) -> Optional[float]:
    """Device milliseconds a request of the ops launched under `name`."""
    ops = _launched(view, name)
    if ops is None:
        return None
    return sum(b - a for a, b, *_ in ops) * 1e-3 / view.frames


def op_count(view: TraceView, name: str) -> Optional[float]:
    """Device ops (kernels, copies, memsets) a request launched under
    `name`."""
    ops = _launched(view, name)
    return None if ops is None else len(ops) / view.frames


def gaps(view: TraceView) -> List[Tuple[float, float]]:
    """The stretch's idle gaps: the stretch less the union of its device
    ops, as `TraceView.idle_gaps` takes them."""
    out, t = [], view.t0
    for a, b in view.busy:
        if a > t:
            out.append((t, a))
        t = max(t, b)
    if view.t1 > t:
        out.append((t, view.t1))
    return out


def idle_ms(view: TraceView, name: str) -> Optional[float]:
    """Milliseconds a request in which the device was idle while the host
    was inside `name` (each gap by its middle)."""
    rs = ranges(view, name)
    if not rs or not view.ops or view.frames <= 0:
        return None
    return sum(b - a for a, b in gaps(view)
               if _inside(rs, (a + b) / 2)) * 1e-3 / view.frames
