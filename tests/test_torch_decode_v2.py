"""qoi_tpu_torch's gather-free decoder v2 (models/decode_v2) and its
two-phase table query (table.table_select_local/carry) against the JAX
package on the CPU, and its decode against the C++ oracle. The tolerance
is exact equality everywhere (an integer codec)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qoi_tpu.models import decode_v2 as jv2
from qoi_tpu.ops import table as jtable
from qoi_tpu.utils import testimages
from qoi_tpu_torch import format as fmt
from qoi_tpu_torch import oracle
from qoi_tpu_torch.models import decode_pipeline as tv1
from qoi_tpu_torch.models import decode_v2 as tv2
from qoi_tpu_torch.ops import table as ttable
from torch_testutil import assert_same, oracle_built, to_torch

needs_oracle = pytest.mark.usefixtures("oracle_built")

#: stream bodies of the JAX comparisons pad to this many bytes and decode
#: into N_PX pixels, so the JAX side compiles one program a function
M, N_PX = 32768, 8192


def _encoded(img) -> bytes:
    h, w, ch = img.shape
    return oracle.encode(img, fmt.StreamDesc(w, h, ch))


def _raw_stream(w, h, ch, body: bytes) -> bytes:
    return fmt.pack_header(fmt.StreamDesc(w, h, ch)) + body + fmt.TRAILER


STREAMS = {
    "photo": lambda: _encoded(testimages.photo(96, 64, 4, seed=5)),
    "mixed": lambda: _encoded(testimages.mixed(96, 64, 4, seed=3)),
    "palette_chains": lambda: _encoded(
        testimages.palette(300, 8, 4, colors=12, seed=13)),
    "alpha_toggle": lambda: _encoded(testimages.alpha_toggle(96, 64)),
    "unwritten_index": lambda: _raw_stream(4, 1, 4, bytes([
        fmt.OP_INDEX | 5, fmt.OP_INDEX | 0, fmt.OP_INDEX | 63,
        fmt.OP_RGB, 9, 9, 9])),
    "adversarial": lambda: _raw_stream(64, 32, 4, b"\x05" * (64 * 32)),
}


def _padded(stream: bytes):
    raw = np.frombuffer(stream, np.uint8)[fmt.HEADER_SIZE:]
    pad = np.zeros(M, np.uint8)
    pad[: len(raw)] = raw
    return pad, len(stream) - fmt.HEADER_SIZE - fmt.TRAILER_SIZE


@pytest.fixture(scope="module")
def bodies():
    if not oracle.available():
        pytest.skip("oracle not built")
    return {name: _padded(make()) for name, make in STREAMS.items()}


# ---- table.table_select_local / table_select_carry ----------------------

@pytest.mark.parametrize("n", [100, 1000])
@pytest.mark.parametrize("with_incoming", [False, True])
def test_table_select_matches_jax(n, with_incoming):
    """Phase A then phase B; only phase B's outputs are the JAX ones
    (the phase-A tuple is each package's own)."""
    rng = np.random.default_rng(2 * n + with_incoming)
    keys = rng.integers(0, 64, n).astype(np.int32)
    qkeys = rng.integers(0, 64, n).astype(np.int32)
    vals = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    write = rng.random(n) < 0.6
    inc = (rng.integers(0, 2**32, 64, dtype=np.uint64).astype(np.uint32),
           rng.random(64) < 0.5)
    local = jtable.table_select_local(jnp.asarray(keys), jnp.asarray(vals),
                                      jnp.asarray(write), jnp.asarray(qkeys))
    want = jtable.table_select_carry(
        local, jnp.asarray(qkeys),
        incoming=(tuple(jnp.asarray(a) for a in inc) if with_incoming
                  else None))
    tlocal = ttable.table_select_local(
        to_torch(keys), to_torch(vals.astype(np.int64)), to_torch(write),
        to_torch(qkeys))
    got = ttable.table_select_carry(
        tlocal, to_torch(qkeys),
        incoming=(tuple(to_torch(a) for a in inc) if with_incoming
                  else None))
    assert_same(want[0], got[0])
    assert_same(want[1], got[1])
    for a, b in zip(want[2], got[2]):
        assert_same(a, b)


# ---- v2 stages ----------------------------------------------------------

@needs_oracle
@pytest.mark.parametrize("case", sorted(STREAMS))
def test_fields_match_jax(bodies, case):
    pad, clen = bodies[case]
    want = jv2._fields(jnp.asarray(pad), jnp.int32(clen))
    got = tv2._fields(to_torch(pad), clen)
    assert len(want) == len(got)
    for a, b in zip(want, got):
        assert_same(a, b)


@needs_oracle
@pytest.mark.parametrize("case", sorted(STREAMS))
def test_decode_v2_device_matches_jax(bodies, case):
    pad, clen = bodies[case]
    want, want_conv = jv2._decode_v2_device(jnp.asarray(pad),
                                            jnp.int32(clen), N_PX)
    got, conv, rounds = tv2._decode_v2_device(to_torch(pad), clen, N_PX)
    assert got.dtype == torch.uint8 and got.shape == (4, N_PX)
    assert conv == bool(want_conv)
    assert 1 <= rounds <= tv2._MAX_ROUNDS
    assert_same(want, got)


@needs_oracle
def test_decode_group_matches_jax(bodies):
    """Two streams of one bucket, one of them needing more rounds than the
    other: the JAX group's rounds run together, the port's stream by
    stream, with the same pixels."""
    cases = ("palette_chains", "mixed")
    data = np.stack([bodies[c][0] for c in cases])
    clens = [bodies[c][1] for c in cases]
    want, want_conv = jv2.decode_group(jnp.asarray(data),
                                       jnp.asarray(clens, jnp.int32), N_PX)
    got, conv = tv2.decode_group(to_torch(data), clens, N_PX)
    assert got.shape == (2, 4, N_PX) and conv == bool(want_conv)
    assert_same(want, got)


# ---- v2 decode against the oracle (tests/test_decode_v2.py) ------------

def _roundtrip(img: np.ndarray) -> None:
    stream = _encoded(img)
    got, gdesc = tv2.decode(stream, device="cpu")
    want, wdesc = oracle.decode(stream)
    assert (gdesc.width, gdesc.height, gdesc.channels) == \
        (wdesc.width, wdesc.height, wdesc.channels)
    np.testing.assert_array_equal(got, want)


@needs_oracle
@pytest.mark.parametrize("name", sorted(testimages.edge_case_suite(4)))
def test_v2_edge_cases_rgba(name):
    _roundtrip(testimages.edge_case_suite(4)[name])


@needs_oracle
@pytest.mark.parametrize("name", ["gradient", "palette", "mixed",
                                  "noise_small"])
def test_v2_edge_cases_rgb(name):
    _roundtrip(testimages.edge_case_suite(3)[name])


@needs_oracle
def test_v2_index_indirection_chains():
    """Palette repeats force INDEX chunks whose values flow into later
    table entries read by further INDEX chunks (depth > 1)."""
    _roundtrip(testimages.palette(300, 8, 4, colors=12, seed=13))


@needs_oracle
def test_v2_alpha_varying():
    rng = np.random.default_rng(5)
    img = rng.integers(0, 255, size=(8, 64, 4), dtype=np.uint8)
    img[..., 3] = 200
    img[0, 0, 3] = 130
    _roundtrip(img)


@needs_oracle
def test_v2_truncation_and_channel_forcing():
    full = _encoded(testimages.mixed(40, 30, 4))
    cut = full[: fmt.HEADER_SIZE + 11] + fmt.TRAILER
    np.testing.assert_array_equal(tv2.decode(cut, device="cpu")[0],
                                  oracle.decode(cut)[0])
    for ch in (0, 3, 4):
        np.testing.assert_array_equal(tv2.decode(full, ch, device="cpu")[0],
                                      oracle.decode(full, ch)[0])


@needs_oracle
@pytest.mark.parametrize("case", ["unwritten_index", "adversarial"])
def test_v2_noncanonical_streams(case):
    data = STREAMS[case]()
    np.testing.assert_array_equal(tv2.decode(data, device="cpu")[0],
                                  oracle.decode(data)[0])


@needs_oracle
def test_v2_random_roundtrips():
    rng = np.random.default_rng(0)
    for _ in range(5):
        w = int(rng.integers(1, 90))
        h = int(rng.integers(1, 40))
        ch = int(rng.choice([3, 4]))
        img = testimages.palette(w, h, ch, colors=int(rng.integers(2, 20)),
                                 seed=int(rng.integers(1 << 30)))
        _roundtrip(img)


@needs_oracle
def test_v2_unconverged_stream_falls_back_to_v1(monkeypatch):
    """A stream that does not converge in the round cap goes to the v1
    decoder, with the oracle's pixels."""
    data = _encoded(testimages.palette(300, 8, 4, colors=12, seed=13))
    monkeypatch.setattr(tv2, "_MAX_ROUNDS", 1)
    seen = []
    v1 = tv1.decode
    monkeypatch.setattr(tv1, "decode", lambda *a: seen.append(a[0]) or v1(*a))
    np.testing.assert_array_equal(tv2.decode(data, device="cpu")[0],
                                  oracle.decode(data)[0])
    assert seen == [data]
