"""qoi_tpu_torch.headline, the port's headline benchmark, on the CPU: its
gates (every encode the oracle's bytes, every decode its source pixels and
converged, the adversarial decode the oracle's), the verify_failed line and
exit code 1 on a corrupted result, the refusal to time without a card, and
its result line's keys: those of the repository's bench.py (parsed from
its source text, which imports JAX inside main) plus the port's own."""
import ast
import json
import pathlib

import pytest
import torch

from qoi_tpu_torch import headline
from qoi_tpu_torch.models import decode_v3, pipeline
from torch_testutil import oracle_built

pytestmark = pytest.mark.usefixtures("oracle_built")

ROOT = pathlib.Path(__file__).resolve().parent.parent
SMALL = ["--device", "cpu", "--width", "64", "--height", "48",
         "--frames", "2", "--dispatch", "2"]


def _bench_dicts(marker: str) -> list:
    """Key lists of the dict literals in bench.py that have the key
    `marker`, in source order."""
    found = []
    for node in ast.walk(ast.parse((ROOT / "bench.py").read_text())):
        if isinstance(node, ast.Dict):
            keys = [k.value for k in node.keys
                    if isinstance(k, ast.Constant)]
            if marker in keys:
                found.append((node.lineno, keys))
    assert found, f"no dict with {marker!r} in bench.py"
    return [keys for _, keys in sorted(found)]


def _last_json(out: str) -> dict:
    return json.loads(out.strip().splitlines()[-1])


@pytest.fixture
def no_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: timing would run")


def test_check_only_passes_its_gates_on_the_cpu(capsys):
    assert headline.main(["--check-only", *SMALL]) == 0
    out, err = capsys.readouterr()
    assert _last_json(out) == {"verified": True, "device": "cpu"}
    assert len(out.strip().splitlines()) == 1
    assert "all 4 encodes byte-identical" in err
    assert "all 4 photo decodes pixel-identical" in err
    assert "all 4 mixed decodes pixel-identical" in err
    assert "adversarial decode equals oracle.decode" in err
    assert "Mpx/s" not in out


def _flip_encode(monkeypatch, which):
    orig = pipeline.encode_device_wordsum
    calls = []

    def flipped(px4, n_valid, *a, **kw):
        words, total = orig(px4, n_valid, *a, **kw)
        calls.append(1)
        if len(calls) - 1 == which:
            words = words.clone()
            words[0] ^= 1 << 9          # one byte of the stream's first word
        return words, total

    monkeypatch.setattr(pipeline, "encode_device_wordsum", flipped)


def _bad_decode_group(monkeypatch, what):
    orig = decode_v3.decode_group

    def bad(data, clens, npc):
        out, conv, rounds = orig(data, clens, npc)
        if what == "pixel":
            out = out.clone()
            out[-1, 7] ^= 0x100
        else:
            conv = conv.clone()
            conv[0] = False
        return out, conv, rounds

    monkeypatch.setattr(decode_v3, "decode_group", bad)


def _bad_adversarial(monkeypatch):
    orig = decode_v3.decode

    def bad(data, channels, device, config=None):
        img, desc = orig(data, channels, device, config)
        img = img.copy()
        img[0, 0, 0] ^= 1
        return img, desc

    monkeypatch.setattr(decode_v3, "decode", bad)


@pytest.mark.parametrize("fault", ["encode first", "encode last",
                                   "decode pixel", "decode converged",
                                   "adversarial"])
def test_a_failed_gate_prints_verify_failed_and_exits_1(
        monkeypatch, capsys, fault):
    if fault == "encode first":
        _flip_encode(monkeypatch, 0)
    elif fault == "encode last":
        _flip_encode(monkeypatch, 3)    # frames 2 x dispatch 2
    elif fault == "decode pixel":
        _bad_decode_group(monkeypatch, "pixel")
    elif fault == "decode converged":
        _bad_decode_group(monkeypatch, "conv")
    else:
        _bad_adversarial(monkeypatch)
    assert headline.main(["--check-only", *SMALL]) == 1
    out, err = capsys.readouterr()
    line = _last_json(out)
    assert line["verify_failed"] is True
    for keys in _bench_dicts("verify_failed"):     # the encode and decode
        assert set(keys) <= set(line)               # failures' lines
    assert line["metric"] == headline.METRIC
    assert "verified" not in line
    assert "VERIFY FAILED" in err


def test_timing_on_the_cpu_raises(no_card):
    with pytest.raises(RuntimeError, match="timing needs a CUDA device"):
        headline.main(SMALL)


def test_the_default_device_raises_without_a_card(no_card):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        headline.main([])


def test_result_keys_are_bench_py_keys_plus_the_ports(monkeypatch):
    """The timed result line, with the host clock replaced by fixed
    times (no time is taken on the CPU): bench.py's keys, then
    EXTRA_KEYS, and each rate from its time."""
    monkeypatch.setattr(headline.profiling, "device_sync_times",
                        lambda fn, reps, dev: [0.5] * reps)
    monkeypatch.setattr(headline, "_best_of", lambda fn, reps: 2.0)
    monkeypatch.setattr(headline, "_power_limit_w", lambda dev: 700.0)
    opts = headline._parse(SMALL + ["--reps", "3"])
    res = headline._run(opts, torch.device("cpu"), "cpu")
    bench_keys, = _bench_dicts("decode_adversarial_mpxs")
    assert list(res) == bench_keys + list(headline.EXTRA_KEYS)
    assert headline.EXTRA_KEYS == ("baseline_encode_mpxs",
                                   "baseline_decode_mpxs", "device",
                                   "power_limit_w", "reps")
    n = 64 * 48
    assert res["value"] == 4 * n / 1e6 / 0.5
    assert res["decode_mpxs"] == res["decode_mixed_mpxs"] == 4 * n / 1e6 / 0.5
    assert res["decode_adversarial_mpxs"] == n / 1e6 / 0.5
    assert res["baseline_encode_mpxs"] == 2 * n / 1e6 / 2.0
    assert res["baseline_decode_mpxs"] == 4 * n / 1e6 / 2.0
    assert res["vs_baseline"] == res["value"] / res["baseline_encode_mpxs"]
    assert res["unit"] == "Mpx/s" and res["reps"] == 3
    assert res["power_limit_w"] == 700.0 and res["device"] == "cpu"


def test_no_tpu_host_baseline_in_the_source():
    """bench.py's denominators were measured on the TPU's host; the port
    measures its own."""
    src = (ROOT / "qoi_tpu_torch" / "headline.py").read_text()
    for const in ("163", "228", "BASELINE_ENCODE_MPXS",
                  "BASELINE_DECODE_MPXS"):
        assert const not in src


@pytest.mark.parametrize("argv", [["--reps", "0"], ["--frames", "0"],
                                  ["--dispatch", "0"]])
def test_counts_below_one_are_refused(argv):
    with pytest.raises(SystemExit):
        headline.main(["--check-only", *SMALL, *argv])
