"""qoi_tpu_torch.abperf, the port's same-process A/B harness, on the CPU
with the gates only (--check-only; timing needs a card): every
subcommand's variants at --mini pass their checks, a variant whose output
is corrupted is refused before it is timed, and --only selects by
substring as the repository's tools/abperf.py `_selected` does."""
import ast
import pathlib

import pytest
import torch

from qoi_tpu_torch import abperf
from qoi_tpu_torch.kernels import expand as kexpand
from qoi_tpu_torch.kernels import pack as kpack
from qoi_tpu_torch.models import decode_v3, pipeline
from torch_testutil import oracle_built

pytestmark = pytest.mark.usefixtures("oracle_built")

ROOT = pathlib.Path(__file__).resolve().parent.parent
GATES = ["--mini", "--device", "cpu", "--check-only"]

VARIANTS = {
    "encode": ["wordsum10240", "wordsum20480", "wordsum40960",
               "plainstage20480", "pack", "batch", "facade"],
    "decode": ["v3 surgical", "v3 nosurg", "v3 r1", "v3 scanapply",
               "v3 dense", "v1"] + [f"abl {p}" for p in abperf.ABL_PHASES],
    "expand": ["expand 4k per-byte", "expand 4k dense", "expand synthetic"],
    "pack": ["pack full", "pack stages", "pack densify sort",
             "pack densify shift", "pack prep", "pack place_words"],
}
SMALL = {"encode": ["--frames", "2"], "decode": ["--streams", "2"],
         "expand": [], "pack": []}


def _verified(out: str) -> list:
    return [line[: -len(": verified")] for line in out.splitlines()
            if line.endswith(": verified")]


@pytest.mark.parametrize("what", sorted(VARIANTS))
def test_every_variant_passes_its_gates(capsys, what):
    assert abperf.main([what, *GATES, *SMALL[what]]) == 0
    out, _ = capsys.readouterr()
    assert _verified(out) == VARIANTS[what]
    assert "ms" not in out


def test_decode_on_mixed_content_skips_r1(capsys):
    assert abperf.main(["decode", *GATES, "--streams", "3", "--content",
                        "mixed", "--only", "v3,abl round1"]) == 0
    out, err = capsys.readouterr()
    assert _verified(out) == ["v3 surgical", "v3 nosurg", "v3 scanapply",
                              "v3 dense", "abl round1"]
    assert "v3 r1: photo only" in err


def _corrupt(monkeypatch, what):
    """Flip one bit of what one entry point returns."""
    if what == "encode":
        orig = pipeline.encode_device_wordsum

        def bad(*a, **kw):
            words, total = orig(*a, **kw)
            words = words.clone()
            words[3] ^= 1
            return words, total
        monkeypatch.setattr(pipeline, "encode_device_wordsum", bad)
    elif what == "decode":
        orig = decode_v3._decode_device

        def bad(*a, **kw):
            out, conv, rounds = orig(*a, **kw)
            out = out.clone()
            out[100] ^= 1 << 24
            return out, conv, rounds
        monkeypatch.setattr(decode_v3, "_decode_device", bad)
    elif what == "expand":
        orig = kexpand.expand_px

        def bad(*a, **kw):
            out = orig(*a, **kw).clone()
            out[-1] ^= 2
            return out
        monkeypatch.setattr(kexpand, "expand_px", bad)
    else:
        orig = kpack.place_words

        def bad(*a, **kw):
            out = orig(*a, **kw).clone()
            out[0] ^= 1
            return out
        monkeypatch.setattr(kpack, "place_words", bad)


@pytest.mark.parametrize("what,only", [
    ("encode", "wordsum20480"), ("decode", "v3 scanapply"),
    ("decode", "abl expand"), ("expand", "expand synthetic"),
    ("pack", "pack place_words")])
def test_a_corrupted_variant_is_refused(monkeypatch, capsys, what, only):
    _corrupt(monkeypatch, what)
    assert abperf.main([what, *GATES, *SMALL[what], "--only", only]) == 1
    out, err = capsys.readouterr()
    assert _verified(out) == []
    assert out.startswith(f"{only}: refused, not timed: ")
    assert f"refused, not timed: {[only]}" in err


def test_a_refused_variant_is_never_timed(monkeypatch, capsys):
    """Without --check-only a variant that fails its check is refused
    before the first timed call: fn runs once, the card is never
    asked."""
    opts = abperf._parse(["decode", "--device", "cpu"])
    h = abperf.Harness(opts, torch.device("cpu"))
    calls = []

    def fn():
        calls.append("call")
        return 0

    def refuse(out):
        abperf._need(False, "corrupted")

    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda *a: calls.append("sync"))
    h.run("v3 x", fn, refuse, 1)
    assert calls == ["call"] and h.refused == ["v3 x"]
    assert capsys.readouterr().out == "v3 x: refused, not timed: corrupted\n"


def test_the_variants_after_a_refused_one_still_run(monkeypatch, capsys):
    """A v1 stream that does not converge is refused (with its
    iterations); the next variant is still verified; the exit code is
    1."""
    from qoi_tpu_torch.models import decode_pipeline

    orig = decode_pipeline._decode_chunks

    def capped(*a, **kw):
        px4, _, iters = orig(*a, **kw)
        return px4, False, iters

    monkeypatch.setattr(decode_pipeline, "_decode_chunks", capped)
    assert abperf.main(["decode", *GATES, "--streams", "2", "--only",
                        "v1,abl fields"]) == 1
    out, _ = capsys.readouterr()
    assert out.splitlines()[0].startswith(
        "v1: refused, not timed: stream 0 did not converge in ")
    assert _verified(out) == ["abl fields"]


def _jax_selected(only):
    """tools/abperf.py's `_selected`, taken from its source text and run
    with `_ONLY` set as its --only option sets it (importing the tool
    would set its compile-cache environment)."""
    src = (ROOT / "tools" / "abperf.py").read_text()
    fn = next(n for n in ast.parse(src).body
              if isinstance(n, ast.FunctionDef) and n.name == "_selected")
    ns = {"_ONLY": [t for t in only.split(",") if t]}
    exec(compile(ast.Module([fn], []), "abperf_selected", "exec"), ns)
    return ns["_selected"]


@pytest.mark.parametrize("only", ["", "v3", "abl initial_w",
                                  "scanapply,abl", "wordsum2", "pack ",
                                  "nothing"])
def test_only_selects_by_substring_as_the_jax_harness(only):
    names = [n for v in VARIANTS.values() for n in v]
    h = abperf.Harness(abperf._parse(["decode", "--only", only]),
                       torch.device("cpu"))
    want = _jax_selected(only)
    assert [n for n in names if h.selected(n)] == \
        [n for n in names if want(n)]


def test_only_abl_initial_w_runs_that_phase_alone(capsys):
    assert abperf.main(["decode", *GATES, "--streams", "2", "--only",
                        "abl initial_w"]) == 0
    out, _ = capsys.readouterr()
    assert _verified(out) == ["abl initial_w"]


@pytest.fixture
def no_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: timing would run")


@pytest.mark.parametrize("argv", [["decode", "--device", "cpu"],
                                  ["encode"]])
def test_timing_without_a_card_raises(no_card, argv):
    with pytest.raises(RuntimeError):
        abperf.main(argv)


def test_synthetic_expand_input_is_the_jax_harness_mix():
    """The synthetic expand input: the JAX harness's run-length mix,
    pix_off nondecreasing from 0, its pixels past the first chunk
    nondecreasing, the capacity m/2 + m/16."""
    po, px, cap = abperf._synthetic_expand(1 << 12)
    assert cap == (1 << 11) + (1 << 8)
    assert po.dtype.name == px.dtype.name == "int32"
    assert po[0] == 0 and (po[1:] >= po[:-1]).all()
    u = px.view("uint32")
    assert (u[1:] >= u[:-1]).all()
    again = abperf._synthetic_expand(1 << 12)
    assert (again[0] == po).all() and (again[1] == px).all()
