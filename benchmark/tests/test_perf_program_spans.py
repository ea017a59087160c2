"""The readers of the program's own spans (`benchmark/program_spans.py`
and the metrics that read through it) on hand-written trace events, and
on a real CPU trace of the port."""
import json

import pytest
import torch

from benchmark import harness, program_spans, tracing

NEW = {"maps_ms": "qoi.decode.maps", "compose_ms": "qoi.decode.compose",
       "apply_ms": "qoi.decode.apply", "certify_ms": "qoi.decode.certify",
       "fixpoint_idle_ms": "qoi.decode.fixpoint",
       "stage_idle_ms": "qoi.encode.stage_chunks",
       "ops.decode": "qoi.decode", "ops.encode": "qoi.encode"}


def _x(name, cat, ts, dur, tid=1, corr=None):
    e = {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
         "tid": tid, "pid": 1}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def _span(name, ts, dur, tid=1):
    return _x(name, "user_annotation", ts, dur, tid)


def _launch(ts, corr, tid=1):
    return _x("cudaLaunchKernel", "cuda_runtime", ts, 5, tid, corr)


def _kernel(name, ts, dur, corr):
    return _x(name, "kernel", ts, dur, tid=7, corr=corr)


def _events():
    """A stretch of 2000 us holding two decode requests; times in us.

    request 1: decode [1100, 1900), fixpoint [1200, 1800) with maps
    [1250, 1400) and certify [1600, 1700) inside it;
    request 2: decode [2100, 2900), fixpoint [2200, 2800) with maps
    [2250, 2400); a second thread's span and launch; one launch between
    the requests, outside every span."""
    return [
        _span(tracing.STRETCH, 1000, 2000),
        _span("qoi.decode", 1100, 800),
        _span("qoi.decode.fixpoint", 1200, 600),
        _span("qoi.decode.maps", 1250, 150),
        _span("qoi.decode.certify", 1600, 100),
        _x("aten::item", "cpu_op", 1650, 50),
        _span("qoi.decode", 2100, 800),
        _span("qoi.decode.fixpoint", 2200, 600),
        _span("qoi.decode.maps", 2250, 150),
        _span("qoi.decode.maps", 2000, 900, tid=2),   # another thread
        _launch(1260, 1),    # maps, request 1
        _launch(1610, 2),    # certify
        _launch(1950, 3),    # between the requests: no span
        _launch(2260, 4),    # maps, request 2
        _launch(2270, 5, tid=2),  # the other thread's launch
        _launch(2500, 6),    # fixpoint, outside maps; runs after it
        _launch(900, 7),     # before the stretch
        _kernel("k_maps1", 1300, 50, 1),
        _kernel("k_cert", 1620, 20, 2),
        _kernel("k_between", 1960, 40, 3),
        _kernel("k_maps2", 2300, 30, 4),
        _kernel("k_other", 2400, 10, 5),
        _kernel("k_late", 2850, 50, 6),
        _kernel("k_before", 950, 100, 7),    # cut at 1000
    ]


def _view(events=None, frames=2):
    return tracing.TraceView(_events() if events is None else events, (),
                             frames=frames)


def _ctx(view):
    return harness.Context(None, 0.0, harness.Window(), view, 0)


def _read(name, view):
    reader = harness.load_metric(harness.ROOT, {"name": name}).reader
    return reader.read(_ctx(view))


def test_ranges_are_the_stretch_threads_own():
    v = _view()
    assert program_spans.ranges(v, "qoi.decode.maps") == \
        [(1250, 1400), (2250, 2400)]
    assert program_spans.ranges(v, "qoi.decode.compose") == []


def test_device_time_by_launch_inside_nested_spans():
    v = _view()
    # maps: k_maps1 50 + k_maps2 30 over two requests; the other
    # thread's launch inside a maps range of its own does not count
    assert program_spans.device_ms(v, "qoi.decode.maps") == \
        pytest.approx(0.040)
    assert program_spans.device_ms(v, "qoi.decode.certify") == \
        pytest.approx(0.010)
    # inclusive: the fixpoint holds maps, certify and k_late, which ran
    # after the span closed but was launched inside it
    assert program_spans.device_ms(v, "qoi.decode.fixpoint") == \
        pytest.approx((50 + 20 + 30 + 50) / 2 / 1000)
    # a launch outside every span counts for none
    assert program_spans.device_ms(v, "qoi.decode") == \
        pytest.approx((50 + 20 + 30 + 50) / 2 / 1000)


def test_op_count_per_request():
    v = _view()
    assert program_spans.op_count(v, "qoi.decode") == 2.0     # 4 ops
    assert program_spans.op_count(v, "qoi.decode.maps") == 1.0
    assert program_spans.op_count(_view(frames=4), "qoi.decode") == 1.0


def test_idle_gap_by_its_middle():
    v = _view()
    # busy: [1000,1050] (cut), [1300,1350], [1620,1640], [1960,2000],
    # [2300,2330], [2400,2410], [2850,2900]; gaps and their middles:
    # [1050,1300] 1175 decode; [1350,1620] 1485 fixpoint;
    # [1640,1960] 1800 decode (the fixpoint ends at 1800);
    # [2000,2300] 2150 decode; [2330,2400] 2365 maps;
    # [2410,2850] 2630 fixpoint; [2900,3000] 2950 outside
    assert [(a, b) for a, b in program_spans.gaps(v)] == [
        (1050, 1300), (1350, 1620), (1640, 1960), (2000, 2300),
        (2330, 2400), (2410, 2850), (2900, 3000)]
    assert program_spans.idle_ms(v, "qoi.decode.fixpoint") == \
        pytest.approx((270 + 70 + 440) / 2 / 1000)
    assert program_spans.idle_ms(v, "qoi.decode.maps") == \
        pytest.approx(70 / 2 / 1000)
    assert program_spans.idle_ms(v, "qoi.decode") == \
        pytest.approx((250 + 270 + 320 + 300 + 70 + 440) / 2 / 1000)
    assert program_spans.idle_ms(v, "qoi.decode.certify") == 0.0
    # the gaps add up to the stretch's idle time
    idle = sum(b - a for a, b in program_spans.gaps(v)) * 1e-6
    assert idle == pytest.approx(v.window_s - v.busy_s)


def test_readers_on_the_events():
    v = _view()
    assert _read("maps_ms", v) == pytest.approx(0.040)
    assert _read("certify_ms", v) == pytest.approx(0.010)
    assert _read("fixpoint_idle_ms", v) == pytest.approx(0.390)
    assert _read("ops.decode", v) == 2.0
    # spans absent from the stretch: the metric is left out
    for name in ("compose_ms", "apply_ms", "stage_idle_ms", "ops.encode"):
        assert _read(name, v) is None


def test_encode_readers():
    ev = [_span(tracing.STRETCH, 0, 1000),
          _span("qoi.encode", 100, 400),
          _span("qoi.encode.stage_chunks", 120, 200),
          _span("qoi.encode.compact", 330, 150),
          _launch(300, 1), _launch(340, 2), _launch(350, 3),
          _kernel("stage", 310, 10, 1), _kernel("add", 400, 50, 2),
          _kernel("copy", 450, 20, 3)]
    v = _view(ev, frames=1)
    # gaps [0,310] mid 155 in stage_chunks; [320,400] mid 360 compact;
    # [470,1000] mid 735 outside
    assert _read("stage_idle_ms", v) == pytest.approx(0.310)
    assert _read("ops.encode", v) == 3.0
    assert _read("ops.decode", v) is None


@pytest.mark.parametrize("name", sorted(NEW))
def test_nothing_to_read(name):
    assert _read(name, None) is None
    # a stretch with the span but no device op: nothing on the card
    bare = [_span(tracing.STRETCH, 0, 100), _span(NEW[name], 10, 50)]
    assert _read(name, _view(bare)) is None
    assert _read(name, _view(frames=0)) is None


@pytest.mark.parametrize("name", sorted(NEW))
def test_new_metrics_declare_their_program_spans(name):
    reader = harness.load_metric(harness.ROOT, {"name": name}).reader
    assert reader.SPANS == ()
    assert reader.PROGRAM_SPANS == (NEW[name],)
    bench = harness.load_benchmark()
    spec = {m["name"]: m for m in bench["per_layer"]}[name]
    assert spec["source"] == "device_trace"
    assert set(spec["workloads"]) == (
        {"capture4k-encode"} if NEW[name].startswith("qoi.encode")
        else {"texture4k-decode", "capture4k-decode"})


def test_program_spans_in_a_cpu_trace(tmp_path):
    """The port's spans reach the TraceView's host events on the stretch's
    thread; on the CPU there is no device op, so nothing is read."""
    from qoi_tpu_torch.models import pipeline
    from qoi_tpu_torch.utils import testimages
    px = torch.from_numpy(testimages.mixed(32, 16, 4, seed=1)
                          .reshape(-1, 4).copy())
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function(tracing.STRETCH):
            pipeline.encode_device_wordsum(px, px.shape[0])
    path = tmp_path / "t.json"
    prof.export_chrome_trace(str(path))
    v = tracing.TraceView(json.loads(path.read_text())["traceEvents"], (),
                          frames=1)
    for name in ("qoi.encode", "qoi.encode.stage_chunks",
                 "qoi.encode.compact"):
        assert len(program_spans.ranges(v, name)) == 1, name
    assert _read("ops.encode", v) is None
