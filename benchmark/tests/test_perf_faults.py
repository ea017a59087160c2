"""A run with the timed path broken underneath comes out not correct.

Each test drives the whole harness at a small size on the CPU (the look
for a card is run.py's, skipped here) with one fault planted in the
program's entry as the window calls it."""
import pytest
import torch

from benchmark import harness
from conftest import SMALL
from qoi_tpu_torch.models import decode_v3, pipeline


def _run(workload, seed=2**31 + 21):
    result, _ = harness.run_cell(workload, seed, 0.3, False, device="cpu",
                                 overrides=SMALL)
    return result


@pytest.mark.parametrize("workload", ["capture4k-encode", "texture4k-decode",
                                      "capture4k-decode"])
def test_sound_run_is_correct(workload):
    r = _run(workload)
    assert r["correct"] and r["failed"] == 0 and r["attempted"] > 0
    assert list(r)[-1] == "checks"
    assert all(c["value"] == 0 for c in r["checks"].values())


def _encode_fault(kind):
    orig = pipeline.encode_device_wordsum

    def broken(px4, n_valid, *a, **k):
        words, total = orig(px4, n_valid, *a, **k)
        if kind == "altered":      # one answer byte altered where made
            words = words.clone()
            words[3] ^= 0x100
        elif kind == "half":       # half of the stream left out
            total = total // 2
        elif kind == "unwritten":  # the output returned as it started
            words = torch.zeros_like(words)
        return words, total
    return broken


@pytest.mark.parametrize("kind", ["altered", "half", "unwritten"])
def test_encode_fault_is_not_correct(monkeypatch, kind):
    monkeypatch.setattr(pipeline, "encode_device_wordsum",
                        _encode_fault(kind))
    r = _run("capture4k-encode")
    assert not r["correct"]
    assert r["checks"]["bytes_off"]["value"] > 0


def _decode_fault(kind):
    orig = decode_v3.decode_group

    def broken(data, chunks_len, n_px_cap):
        out, conv, rounds = orig(data, chunks_len, n_px_cap)
        n = SMALL["width"] * SMALL["height"]
        if kind == "altered":
            out = out.clone()
            out[0, 7] ^= 1
        elif kind == "half":
            out = out.clone()
            out[0, n // 2:] = 0
        elif kind == "unwritten":
            out = torch.zeros_like(out)
        elif kind == "unconverged":
            conv = torch.zeros_like(conv)
        return out, conv, rounds
    return broken


@pytest.mark.parametrize("workload", ["texture4k-decode", "capture4k-decode"])
@pytest.mark.parametrize("kind", ["altered", "half", "unwritten",
                                  "unconverged"])
def test_decode_fault_is_not_correct(monkeypatch, workload, kind):
    monkeypatch.setattr(decode_v3, "decode_group", _decode_fault(kind))
    r = _run(workload)
    assert not r["correct"]
    if kind == "unconverged":
        assert r["failed"] == r["attempted"] > 0
    else:
        assert r["checks"]["px_off"]["value"] > 0


@pytest.mark.parametrize("at", [3, 12])  # in the warm-up, in the window
def test_request_that_raises_is_a_failure(monkeypatch, at):
    calls = []
    orig = pipeline.encode_device_wordsum

    def flaky(px4, n_valid, *a, **k):
        calls.append(1)
        if len(calls) == at:
            raise RuntimeError("planted")
        return orig(px4, n_valid, *a, **k)
    monkeypatch.setattr(pipeline, "encode_device_wordsum", flaky)
    r = _run("capture4k-encode")
    assert not r["correct"] and r["checks"]["failed"]["value"] == 1
