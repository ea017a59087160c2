"""Layer spans and the reading of a torch.profiler trace.

Spans: `record_function` ranges that the benchmark puts around named
functions of the program by replacing the module attribute for the
length of a traced run (`layer_spans`). The program is not edited. A
target is written "package.module.function"; one the module lacks is
not installed, and every metric that needs it reads nothing.

The reading (`TraceView`) works on the Chrome trace that torch.profiler
exports, over one stretch of the window that the harness marks with the
`STRETCH` range:

- device ops are the trace's kernel, memcpy and memset events; each is
  tied to the host call that launched it by its correlation id, and it
  counts for every span whose range holds that launch on the same host
  thread (inclusive device time; a layer's self time is its span less
  the spans of the layers inside it);
- busy time is the union of the device ops' intervals inside the
  stretch, idle the rest of the stretch;
- each idle gap is named by the innermost host event that spans its
  middle (what the host was doing while the device waited).
"""
from __future__ import annotations

import bisect
import contextlib
import functools
import importlib
import json
import os
import tempfile
from collections import defaultdict
from typing import Dict, Iterable, List, Optional, Tuple

import torch

STRETCH = "benchmark.stretch"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
TOP = 10


def _resolve(target: str):
    mod_name, _, attr = target.rpartition(".")
    try:
        mod = importlib.import_module(mod_name)
    except ImportError:
        return None, attr
    return mod, attr


def _wrapped(fn, name: str):
    @functools.wraps(fn)
    def inner(*args, **kwargs):
        with torch.profiler.record_function(name):
            return fn(*args, **kwargs)
    return inner


@contextlib.contextmanager
def layer_spans(targets: Iterable[str]):
    """Wrap each target function in a span named after the target for
    the length of the block; yields the set of targets installed."""
    undo: List[Tuple[object, str, object]] = []
    installed = set()
    try:
        for target in sorted(set(targets)):
            mod, attr = _resolve(target)
            fn = getattr(mod, attr, None) if mod is not None else None
            if not callable(fn):
                continue
            undo.append((mod, attr, fn))
            setattr(mod, attr, _wrapped(fn, target))
            installed.add(target)
        yield installed
    finally:
        for mod, attr, fn in reversed(undo):
            setattr(mod, attr, fn)


def export_events(prof) -> List[dict]:
    """The profiler's Chrome trace events (written to a temporary file
    under TMPDIR and read back)."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            data = json.load(f)
    finally:
        os.unlink(path)
    return data["traceEvents"] if isinstance(data, dict) else data


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


class TraceView:
    """One traced stretch: device time by span, busy and idle time, and the
    breakdown. Times in the trace are microseconds; methods return
    seconds or milliseconds as named."""

    def __init__(self, events: List[dict], installed: Iterable[str] = (),
                 frames: int = 0):
        self.installed = set(installed)
        self.frames = frames
        xs = [e for e in events if e.get("ph") == "X" and "dur" in e]
        stretch = [e for e in xs if e.get("name") == STRETCH
                   and e.get("cat") == "user_annotation"]
        if stretch:
            s = stretch[0]
            self.t0, self.t1 = float(s["ts"]), float(s["ts"]) + float(s["dur"])
        else:
            self.t0 = self.t1 = 0.0
        launch_at: Dict[object, Tuple[float, object]] = {}
        for e in xs:
            if e.get("cat") in LAUNCH_CATS:
                corr = (e.get("args") or {}).get("correlation")
                if corr is not None:
                    launch_at[corr] = (float(e["ts"]), e.get("tid"))
        self.ops = []  # (start, end, name, launch ts, launch tid)
        for e in xs:
            if e.get("cat") not in DEVICE_CATS:
                continue
            a = float(e["ts"])
            b = a + float(e["dur"])
            if b <= self.t0 or a >= self.t1:
                continue
            corr = (e.get("args") or {}).get("correlation")
            lt, tid = launch_at.get(corr, (None, None))
            self.ops.append((max(a, self.t0), min(b, self.t1), e["name"],
                             lt, tid))
        spans: Dict[Tuple[str, object], List[Tuple[float, float]]] = \
            defaultdict(list)
        self.entered = set()
        self.main_tid = stretch[0].get("tid") if stretch else None
        self.host: List[Tuple[float, float, str]] = []
        for e in xs:
            cat = e.get("cat")
            a = float(e["ts"])
            b = a + float(e["dur"])
            if cat == "user_annotation" and e["name"] in self.installed:
                spans[(e["name"], e.get("tid"))].append((a, b))
                if a < self.t1 and b > self.t0:
                    self.entered.add(e["name"])
            if (cat in HOST_CATS and e["name"] != STRETCH
                    and e.get("tid") == self.main_tid
                    and b > self.t0 and a < self.t1):
                self.host.append((a, b, e["name"]))
        # the union of each name's ranges on each thread: a launch is
        # inside the span when one of these holds it
        self.spans = {k: _union(v) for k, v in spans.items()}
        self.busy = _union([(a, b) for a, b, *_ in self.ops])

    # -- totals ---------------------------------------------------------
    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) * 1e-6

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy) * 1e-6

    # -- spans ----------------------------------------------------------
    def _in_span(self, name: str, ts: float, tid) -> bool:
        ranges = self.spans.get((name, tid), [])
        i = bisect.bisect_right(ranges, (ts, float("inf"))) - 1
        return i >= 0 and ranges[i][0] <= ts < ranges[i][1]

    def span_device_s(self, name: str) -> Optional[float]:
        """Device seconds of the ops launched inside the span `name`; None
        where the span was not installed or never entered in the stretch,
        or the trace holds no device op."""
        if name not in self.installed or name not in self.entered \
                or not self.ops:
            return None
        return sum(b - a for a, b, _, lt, tid in self.ops
                   if lt is not None and self._in_span(name, lt, tid)) * 1e-6

    def span_ms(self, name: str) -> Optional[float]:
        """Device milliseconds a frame under the span `name` (see
        `span_device_s`)."""
        s = self.span_device_s(name)
        if s is None or self.frames <= 0:
            return None
        return s * 1e3 / self.frames

    # -- breakdown ------------------------------------------------------
    def device_ops(self, top: int = TOP) -> List[List]:
        """[[name, seconds]] of the device ops that took most time."""
        tot: Dict[str, float] = defaultdict(float)
        for a, b, name, _, _ in self.ops:
            tot[name] += (b - a) * 1e-6
        return [[k, v] for k, v in
                sorted(tot.items(), key=lambda kv: -kv[1])[:top]]

    def idle_gaps(self, top: int = TOP) -> List[List]:
        """[[host activity, seconds]]: the idle time of the stretch, each
        gap named by the innermost host event over its middle, summed by
        name, largest first."""
        if not self.ops:
            return []
        gaps, t = [], self.t0
        for a, b in self.busy:
            if a > t:
                gaps.append((t, a))
            t = max(t, b)
        if self.t1 > t:
            gaps.append((t, self.t1))
        # a sweep over the host events of the stretch's thread, which
        # nest: the innermost event holding a time is the latest started
        # one still open
        host = sorted(self.host, key=lambda h: (h[0], -h[1]))
        tot: Dict[str, float] = defaultdict(float)
        stack: List[Tuple[float, float, str]] = []
        j = 0
        for a, b in gaps:
            mid = (a + b) / 2
            while j < len(host) and host[j][0] <= mid:
                while stack and stack[-1][1] <= host[j][0]:
                    stack.pop()
                stack.append(host[j])
                j += 1
            while stack and stack[-1][1] <= mid:
                stack.pop()
            name = stack[-1][2] if stack else "host outside any traced call"
            tot[name] += (b - a) * 1e-6
        return [[k, v] for k, v in
                sorted(tot.items(), key=lambda kv: -kv[1])[:top]]
