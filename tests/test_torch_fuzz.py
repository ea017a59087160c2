"""Differential fuzz of the port's decode and encode paths on the CPU
against the C++ oracle (the port's counterpart of tests/test_fuzz.py).

The cases are qoi_tpu_torch/utils/fuzzcases.py's seeded families (a)-(g),
shared with tests/test_torch_fuzz_gpu.py and chip_smoke.py, which run the
same seeds on the card. Each test is one family through one path: every
stream the oracle rejects the path rejects with ValueError, every stream
it accepts the path decodes to the oracle's pixels and descriptor, and any
other exception fails; every encode path gives the oracle's bytes. The
quick tier runs (f) and (g) cut down; the `slow` tier runs their full
counts.
"""
import numpy as np
import pytest
import torch

from qoi_tpu_torch import format as fmt
from qoi_tpu_torch import oracle
from qoi_tpu_torch.models import decode_pipeline
from qoi_tpu_torch.utils import fuzzcases as fz
from qoi_tpu_torch.utils import testimages
from torch_testutil import oracle_built

pytestmark = pytest.mark.usefixtures("oracle_built")

FAMILIES = "abcdefg"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: these decodes run many small ops, which the
    suite's parallel workers would otherwise oversubscribe the cores
    with."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def quick():
    """family -> (cases, the oracle's answers), the quick subset."""
    return {k: (cases, [fz.oracle_answer(c) for c in cases])
            for k, cases in fz.families(full=False).items()}


@pytest.fixture(scope="module")
def full():
    return {k: (cases, [fz.oracle_answer(c) for c in cases])
            for k, cases in fz.families(full=True).items() if k in "fg"}


@pytest.mark.parametrize("path", fz.DECODE_PATHS)
@pytest.mark.parametrize("family", FAMILIES)
def test_decode_family_matches_oracle(quick, family, path):
    cases, wants = quick[family]
    assert fz.check_decode(path, cases, "cpu", wants) == []


@pytest.mark.slow
@pytest.mark.parametrize("path", fz.DECODE_PATHS)
@pytest.mark.parametrize("family", "fg")
def test_decode_family_full_counts_match_oracle(full, family, path):
    cases, wants = full[family]
    assert fz.check_decode(path, cases, "cpu", wants) == []


@pytest.mark.parametrize("path", fz.ENCODE_PATHS)
def test_encode_random_images_match_oracle(path):
    assert fz.check_encode(path, fz.encode_images(10), "cpu") == []


@pytest.mark.slow
@pytest.mark.parametrize("path", fz.ENCODE_PATHS)
def test_encode_random_images_full_count_match_oracle(path):
    assert fz.check_encode(path, fz.encode_images(30), "cpu") == []


def test_families_are_seeded_and_capped(quick):
    """The same seeds give the same cases; the counts of tests/test_fuzz.py
    (one stream of (c) has a valid header above the cap); no valid header
    above CAP_PX pixels."""
    again = fz.families(full=False)
    counts = {}
    for k, (cases, _) in quick.items():
        assert again[k] == cases
        counts[k] = len(cases)
        for c in cases:
            try:
                assert fmt.unpack_header(c.data).num_pixels <= fz.CAP_PX
            except ValueError:
                pass
    assert counts == {"a": 40, "b": 30, "c": 29, "d": 8, "e": 5,
                      "f": 15, "g": 10}


def test_multiblock_mutates_past_the_header_and_truncates():
    """(f): a mutated stream keeps its base's header and length and
    differs in at most 12 bytes; a truncated one is a prefix of its base,
    the trailer put back or not; channels in {0, 3, 4}; 25 + 20 streams
    of each of the three bases."""
    rng = np.random.default_rng(0)
    for _, base in fz.multiblock_bases():
        for c in fz.mutations("f", base, 20, rng):
            assert len(c.data) == len(base) and c.channels in (0, 3, 4)
            diff = np.flatnonzero(np.frombuffer(c.data, np.uint8)
                                  != np.frombuffer(base, np.uint8))
            assert len(diff) <= 12 and (diff >= fmt.HEADER_SIZE).all()
        kinds = set()
        for c in fz.truncations("f", base, 20, rng):
            assert c.channels in (0, 3, 4)
            if base.startswith(c.data) and len(c.data) < len(base):
                kinds.add("cut")
            else:
                cut = c.data[:-fmt.TRAILER_SIZE]
                assert c.data.endswith(fmt.TRAILER) and base.startswith(cut)
                kinds.add("cut + trailer")
        assert kinds == {"cut", "cut + trailer"}
    assert len(fz.multiblock()) == 3 * (25 + 20)


def test_encode_images_cover_the_shape_kinds():
    """(g) holds 1xN and Nx1 images, images under one 1024-pixel block and
    images within 32 pixels of a multiple of 1024, both channel counts."""
    imgs = [im for _, im in fz.encode_images(30)]
    n = [im.shape[0] * im.shape[1] for im in imgs]
    assert any(im.shape[1] == 1 and im.shape[0] > 1 for im in imgs)
    assert any(im.shape[0] == 1 and im.shape[1] > 1 for im in imgs)
    assert any(k < 1024 for k in n)
    near = [k % 1024 for k in n if k > 1024]
    assert any(0 < r <= 32 for r in near) and any(r >= 1024 - 32
                                                  for r in near)
    assert {im.shape[2] for im in imgs} == {3, 4}


def test_verdict():
    """`problem`: a rejection agrees with a rejecting oracle; acceptance
    there, a rejection of an accepted stream, other pixels, another
    descriptor or any other exception is a problem."""
    img = testimages.mixed(5, 3, 4)
    desc = fmt.StreamDesc(5, 3, 4)
    want = (img, desc)
    assert fz.problem(None, ("reject", "bad magic")) is None
    assert fz.problem(want, ("ok", img.copy(), desc)) is None
    assert "oracle rejects" in fz.problem(None, ("ok", img, desc))
    assert "oracle accepts" in fz.problem(want, ("reject", "x"))
    assert "pixels" in fz.problem(want, ("ok", img[..., :3], desc))
    assert "descriptor" in fz.problem(
        want, ("ok", img, fmt.StreamDesc(5, 3, 4, 1)))
    assert "IndexError" in fz.problem(None, ("error", "IndexError: x"))
    got = fz.decode_outcomes("P1 facade", [fz.Case("x", b"\x00" * 30)],
                             "cpu")
    assert got[0][0] == "reject"


def test_ladder_without_native_reaches_v1(monkeypatch):
    """P2 hides the native decoder: the adversarial stream (INDEX reads of
    a never-written slot), on which the device fixpoint does not converge,
    goes to v1, and the native decoder is visible again after."""
    desc = fmt.StreamDesc(64, 16, 4)
    case = fz.Case("x", fmt.pack_header(desc) + b"\x05" * desc.num_pixels
                   + fmt.TRAILER)
    want = oracle.decode(case.data)[0]
    calls = []
    real = decode_pipeline.decode
    monkeypatch.setattr(decode_pipeline, "decode",
                        lambda *a: calls.append(1) or real(*a))
    (kind, px, _), = fz.decode_outcomes("P2 ladder without native", [case],
                                        "cpu")
    assert kind == "ok" and np.array_equal(px, want) and calls == [1]
    assert oracle.available()
    (kind, px, _), = fz.decode_outcomes("P1 facade", [case], "cpu")
    assert kind == "ok" and np.array_equal(px, want) and calls == [1]
