"""The port's spans (utils/profiling.annotate at every layer of the encode
and decode entry points) on the CPU: each appears and nests where it
should, every span and function the benchmark's metrics read exists, the
program's spans hold the same ops as the benchmark's wrappers of the
functions they replace, and with no profiler running `annotate` never
enters record_function."""
import pathlib

import pytest
import torch

from benchmark import harness, tracing
from qoi_tpu_torch import format as fmt
from qoi_tpu_torch.models import decode_pipeline as v1
from qoi_tpu_torch.models import decode_v3, pipeline
from qoi_tpu_torch.utils import testimages

METRICS = pathlib.Path(harness.ROOT) / "benchmark" / "metrics"

#: every span of the port and the span it nests in (None: the request);
#: the estimate runs once before the fixpoint and once inside it for
#: every round after the first
PARENTS = {
    "qoi.encode": {None},
    "qoi.encode.stage_chunks": {"qoi.encode"},
    "qoi.encode.compact": {"qoi.encode"},
    "qoi.decode": {None},
    "qoi.decode.fields": {"qoi.decode"},
    "qoi.decode.estimate": {"qoi.decode", "qoi.decode.fixpoint"},
    "qoi.decode.fixpoint": {"qoi.decode"},
    "qoi.decode.maps": {"qoi.decode.fixpoint"},
    "qoi.decode.compose": {"qoi.decode.fixpoint"},
    "qoi.decode.apply": {"qoi.decode.fixpoint"},
    "qoi.decode.certify": {"qoi.decode.fixpoint"},
    "qoi.decode.expand": {"qoi.decode"},
}

V3 = "qoi_tpu_torch.models.decode_v3"
STAGE = "qoi_tpu_torch.models.pipeline.encode_stage_chunks"
COMPACT = "qoi_tpu_torch.ops.compact.compact_words6_wordsum"
FIELDS, INIT_W, ANCH, CORE, EXPAND = (
    f"{V3}._fields", f"{V3}.initial_w_scan", f"{V3}._anchored_w",
    f"{V3}._decode_core", f"{V3}._expand_packed")
#: layers 2-7: the program's span and the benchmark wrappers it replaces
LAYERS = {
    "qoi.encode.stage_chunks": (STAGE,),
    "qoi.encode.compact": (COMPACT,),
    "qoi.decode.fields": (FIELDS,),
    "qoi.decode.estimate": (INIT_W, ANCH),
    "qoi.decode.expand": (EXPAND,),
}


def _metric_readers():
    return {p.stem: harness.load_metric(harness.ROOT, {"name": p.stem}).reader
            for p in sorted(METRICS.glob("*.py"))}


def _wrapped_targets():
    return sorted({t for r in _metric_readers().values()
                   for t in getattr(r, "SPANS", ())})


def _decode_input(words, total):
    """One stream body from the port's encode, padded as decode_group
    takes it, and its chunk length."""
    tot = int(total)
    data = torch.zeros((1, v1.bucket_size_fine(tot + len(fmt.TRAILER))),
                       dtype=torch.uint8)
    data[0, :tot] = words.view(torch.uint8)[:tot]
    data[0, tot:tot + len(fmt.TRAILER)] = torch.tensor(list(fmt.TRAILER),
                                                       dtype=torch.uint8)
    return data, tot


@pytest.fixture(scope="module")
def traced():
    """A varying-alpha frame encoded and its stream decoded (two fixpoint
    rounds) under torch.profiler on the CPU, with the benchmark's wrappers
    of the functions its metrics read installed. Returns the trace's
    complete events and the decode's rounds."""
    img = testimages.mixed(64, 48, 4, seed=0)
    px = torch.from_numpy(img.reshape(-1, 4).copy())
    n = px.shape[0]
    with tracing.layer_spans(_wrapped_targets()) as installed:
        assert installed == set(_wrapped_targets())
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            words, total = pipeline.encode_device_wordsum(px, n)
            data, clen = _decode_input(words, total)
            out, conv, rounds = decode_v3.decode_group(
                data, [clen], v1.bucket_size(n))
    assert bool(conv[0])
    assert torch.equal(out[0, :n], px.view(torch.int32).reshape(-1))
    events = [e for e in tracing.export_events(prof)
              if e.get("ph") == "X" and "dur" in e]
    return events, int(rounds[0])


def _spans(events, names):
    return [e for e in events if e.get("cat") == "user_annotation"
            and e["name"] in names]


def _ops_under(events, spans):
    """The (ts, name) of every aten op inside one of `spans` on its
    thread."""
    out = set()
    for s in spans:
        a, b = s["ts"], s["ts"] + s["dur"]
        out |= {(e["ts"], e["name"]) for e in events
                if e.get("cat") == "cpu_op" and e.get("tid") == s.get("tid")
                and a <= e["ts"] and e["ts"] + e["dur"] <= b}
    return out


def test_every_span_appears_and_nests_in_its_parent(traced):
    events, rounds = traced
    assert rounds >= 2  # the rebuild's estimate runs inside the fixpoint
    spans = sorted(_spans(events, PARENTS), key=lambda e: (e["ts"], -e["dur"]))
    assert {e["name"] for e in spans} == set(PARENTS)
    seen = {k: set() for k in PARENTS}
    stack = []
    for e in spans:
        while stack and stack[-1]["ts"] + stack[-1]["dur"] <= e["ts"]:
            stack.pop()
        parent = stack[-1] if stack else None
        if parent is not None:
            assert parent.get("tid") == e.get("tid")
            assert e["ts"] + e["dur"] <= parent["ts"] + parent["dur"], \
                (e["name"], parent["name"])
        seen[e["name"]].add(None if parent is None else parent["name"])
        stack.append(e)
    assert seen == PARENTS


def test_the_spans_and_functions_the_metrics_read_exist(traced):
    events, _ = traced
    entered = {e["name"] for e in events if e.get("cat") == "user_annotation"}
    readers = _metric_readers()
    program = {name: r.PROGRAM_SPANS for name, r in readers.items()
               if "program_spans" in (METRICS / f"{name}.py").read_text()}
    assert len(program) >= 8
    for name, spans in program.items():
        assert spans and set(spans) <= entered, name
    for target in _wrapped_targets():
        mod, attr = tracing._resolve(target)
        assert mod is not None and callable(getattr(mod, attr, None)), target
    assert set(_wrapped_targets()) == {t for ts in LAYERS.values()
                                       for t in ts} | {CORE}


@pytest.mark.parametrize("span", sorted(LAYERS))
def test_program_span_holds_the_wrappers_ops(traced, span):
    events, _ = traced
    got = _ops_under(events, _spans(events, {span}))
    assert got and got == _ops_under(events, _spans(events, LAYERS[span]))


def test_fixpoint_span_is_the_core_less_its_layers(traced):
    events, _ = traced
    fix = _ops_under(events, _spans(events, {"qoi.decode.fixpoint"}))
    est = _ops_under(events, _spans(events, {"qoi.decode.estimate"}))
    core = _ops_under(events, _spans(events, {CORE}))
    parts = _ops_under(events, _spans(events, {FIELDS, INIT_W, ANCH}))
    assert fix - est and fix - est == core - parts


def test_off_path_never_enters_record_function(monkeypatch):
    """With no profiler running the spans cost a check and a branch; with
    one running each span enters record_function once."""
    img = testimages.mixed(32, 16, 4, seed=0)
    px = torch.from_numpy(img.reshape(-1, 4).copy())
    n = px.shape[0]
    real = torch.profiler.record_function
    entered = []

    def raising(name):
        raise AssertionError(f"record_function({name!r}) with the profiler "
                             "off")

    monkeypatch.setattr(torch.profiler, "record_function", raising)
    words, total = pipeline.encode_device_wordsum(px, n)
    data, clen = _decode_input(words, total)
    out, conv, _ = decode_v3.decode_group(data, [clen], v1.bucket_size(n))
    assert bool(conv[0])

    def counting(name):
        entered.append(name)
        return real(name)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        pipeline.encode_device_wordsum(px, n)
    assert entered == ["qoi.encode", "qoi.encode.stage_chunks",
                       "qoi.encode.compact"]
