"""The trace readers on a synthetic torch.profiler trace, and the layer
spans' wrapping."""
import sys
import types

import pytest
import torch

from benchmark import harness, tracing

V3 = "qoi_tpu_torch.models.decode_v3"
CORE, FIELDS, INIT_W, ANCH = (f"{V3}._decode_core", f"{V3}._fields",
                              f"{V3}.initial_w_scan", f"{V3}._anchored_w")


def _x(name, cat, ts, dur, tid=1, corr=None):
    e = {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
         "tid": tid, "pid": 1}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def _events():
    """A stretch of 1000 us: the core span with the fields span inside it,
    four launches and one before the stretch; times in us."""
    return [
        _x(tracing.STRETCH, "user_annotation", 1000, 1000),
        _x(CORE, "user_annotation", 1100, 700),
        _x(FIELDS, "user_annotation", 1150, 150),
        _x(INIT_W, "user_annotation", 1450, 100),
        _x("aten::item", "cpu_op", 1700, 200),
        _x("cudaLaunchKernel", "cuda_runtime", 1120, 5, corr=1),
        _x("cudaLaunchKernel", "cuda_runtime", 1160, 5, corr=2),
        _x("cudaLaunchKernel", "cuda_runtime", 1460, 5, corr=3),
        _x("cudaLaunchKernel", "cuda_runtime", 1900, 5, corr=4),
        _x("cudaLaunchKernel", "cuda_runtime", 900, 5, corr=5),
        _x("k_core", "kernel", 1200, 100, tid=7, corr=1),
        _x("k_fields", "kernel", 1300, 50, tid=7, corr=2),
        _x("k_init", "kernel", 1500, 100, tid=7, corr=3),
        _x("k_tail", "kernel", 1950, 100, tid=7, corr=4),   # cut at 2000
        _x("k_before", "kernel", 950, 60, tid=7, corr=5),   # cut at 1000
        _x("ann", "gpu_user_annotation", 1000, 900, tid=7),  # not an op
    ]


def _view(installed=(CORE, FIELDS, INIT_W, ANCH), frames=2):
    return tracing.TraceView(_events(), installed, frames=frames)


def test_busy_is_the_union_inside_the_stretch():
    v = _view()
    assert v.window_s == pytest.approx(1000e-6)
    # [1000,1010] + [1200,1350] + [1500,1600] + [1950,2000]
    assert v.busy_s == pytest.approx(310e-6)
    assert 1 - v.busy_s / v.window_s == pytest.approx(0.69)


def test_span_device_time_is_inclusive():
    v = _view()
    assert v.span_device_s(CORE) == pytest.approx(250e-6)
    assert v.span_device_s(FIELDS) == pytest.approx(50e-6)
    assert v.span_ms(CORE) == pytest.approx(0.125)  # two frames


def test_span_not_entered_or_not_installed_reads_nothing():
    v = _view()
    assert v.span_device_s(ANCH) is None   # installed, never entered
    assert _view(installed=(CORE,)).span_device_s(FIELDS) is None


def _ctx(view, stretch_bytes=0, window=None):
    return harness.Context(None, 0.0, window or harness.Window(), view,
                           stretch_bytes)


def _read(name, ctx):
    return harness.load_metric(harness.ROOT, {"name": name}).reader.read(ctx)


def test_self_time_subtracts_the_layers_inside():
    ctx = _ctx(_view())
    # core 250 us less fields 50 and initial_w 100; _anchored_w never ran
    assert _read("fixpoint_ms", ctx) == pytest.approx(0.05)
    assert _read("fields_ms", ctx) == pytest.approx(0.025)
    assert _read("estimate_ms", ctx) == pytest.approx(0.05)


def test_missing_function_leaves_the_metric_out():
    # a renamed function is never installed: the readers that need it
    # return None (left out of the line), never 0
    view = _view(installed=(CORE, INIT_W, ANCH))
    ctx = _ctx(view)
    assert _read("fields_ms", ctx) is None
    assert _read("fixpoint_ms", ctx) is None
    assert _read("expand_ms", ctx) is None
    with tracing.layer_spans([f"{V3}._no_such_function", FIELDS]) as inst:
        assert inst == {FIELDS}


def test_no_trace_reads_nothing():
    ctx = _ctx(None)
    for name in ("stage_ms", "compact_ms", "fields_ms", "estimate_ms",
                 "fixpoint_ms", "expand_ms", "roofline_pct.encode",
                 "roofline_pct.decode", "idle_pct.encode", "idle_pct.decode"):
        assert _read(name, ctx) is None
    empty = tracing.TraceView([_x(tracing.STRETCH, "user_annotation", 0, 10)],
                              (CORE,), frames=1)
    win = harness.Window(attempted=10, seconds=1.0, stretch_requests=1,
                         stretch_s=0.5)
    assert _read("idle_pct.decode", _ctx(empty, window=win)) is None
    assert _read("roofline_pct.decode", _ctx(empty, 10**6)) is None


def test_roofline_from_real_bytes_over_busy_time():
    view = _view()
    nbytes = harness.HBM_BYTES_PER_S * 31e-6   # 31 us at the HBM rate
    assert _read("roofline_pct.decode", _ctx(view, nbytes)) == \
        pytest.approx(10.0)


def test_idle_from_busy_time_over_untraced_time():
    # 155 us of device time a request in the stretch (310 us, 2 frames);
    # 8 requests outside it in 1.6 ms of host time, 200 us each
    win = harness.Window(attempted=10, seconds=0.0016 + 0.05,
                         stretch_requests=2, stretch_s=0.05)
    for name in ("idle_pct.encode", "idle_pct.decode"):
        assert _read(name, _ctx(_view(), window=win)) == \
            pytest.approx(22.5)
    # no request outside the stretch, or none in it: nothing to read
    only = harness.Window(attempted=2, seconds=0.05, stretch_requests=2,
                          stretch_s=0.05)
    assert _read("idle_pct.encode", _ctx(_view(), window=only)) is None
    assert _read("idle_pct.decode", _ctx(_view(frames=0), window=win)) \
        is None


def test_breakdown():
    v = _view()
    ops = dict(v.device_ops())
    assert ops["k_core"] == pytest.approx(100e-6)
    assert ops["k_tail"] == pytest.approx(50e-6)
    assert "ann" not in ops
    gaps = v.idle_gaps()
    assert gaps[0][0] == "aten::item"          # [1600, 1950]
    assert gaps[0][1] == pytest.approx(350e-6)
    assert dict(gaps)[CORE] == pytest.approx(340e-6)  # [1010,1200], [1350,1500]


def test_layer_spans_wrap_and_restore():
    mod = types.ModuleType("perf_span_probe")
    mod.f = lambda x: x + 1
    sys.modules[mod.__name__] = mod
    try:
        orig = mod.f
        with tracing.layer_spans(["perf_span_probe.f"]) as inst:
            assert inst == {"perf_span_probe.f"}
            assert mod.f is not orig and mod.f(1) == 2
            with torch.profiler.profile() as prof:
                mod.f(2)
            names = [e.name for e in prof.events()]
            assert "perf_span_probe.f" in names
        assert mod.f is orig
    finally:
        del sys.modules[mod.__name__]
