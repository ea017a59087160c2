"""qoi_tpu_torch's v1 decoder (models/decode_pipeline) and the ops it
needs (scans.cummax, ops/link, table.table_replay) against the JAX
package on the CPU, and its decode against the C++ oracle. The tolerance
is exact equality everywhere (an integer codec)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qoi_tpu.models import decode_pipeline as jv1
from qoi_tpu.ops import fsm as jfsm
from qoi_tpu.ops import link as jlink
from qoi_tpu.ops import scans as jscans
from qoi_tpu.ops import table as jtable
from qoi_tpu.utils import testimages
from qoi_tpu_torch import format as fmt
from qoi_tpu_torch import oracle
from qoi_tpu_torch.models import decode_pipeline as tv1
from qoi_tpu_torch.ops import link as tlink
from qoi_tpu_torch.ops import scans as tscans
from qoi_tpu_torch.ops import table as ttable
from torch_testutil import assert_same, to_torch

needs_oracle = pytest.mark.skipif(not oracle.available(),
                                  reason="oracle not built")

#: stream bodies of the JAX comparisons pad to this many bytes and decode
#: into N_PX pixels, so the JAX side compiles one program a function
M, N_PX = 32768, 8192


def _raw_stream(w, h, ch, body: bytes) -> bytes:
    return fmt.pack_header(fmt.StreamDesc(w, h, ch)) + body + fmt.TRAILER


def _alpha_pull() -> bytes:
    """Alpha pulled through INDEX, then used by an RGB literal's hash."""
    h1 = fmt.hash_rgba(1, 2, 3, 77)
    return _raw_stream(5, 1, 4, bytes([
        fmt.OP_RGBA, 1, 2, 3, 77, fmt.OP_RGB, 9, 9, 9, fmt.OP_INDEX | h1,
        fmt.OP_RGB, 20, 20, 20,
        fmt.OP_INDEX | fmt.hash_rgba(20, 20, 20, 77)]))


def _unwritten_index() -> bytes:
    """INDEX reads of never-written slots: the zero entry."""
    return _raw_stream(4, 1, 4, bytes([
        fmt.OP_INDEX | 5, fmt.OP_INDEX | 0, fmt.OP_INDEX | 63,
        fmt.OP_RGB, 9, 9, 9]))


def _encoded(img) -> bytes:
    h, w, ch = img.shape
    return oracle.encode(img, fmt.StreamDesc(w, h, ch))


STREAMS = {
    "mixed": lambda: _encoded(testimages.mixed(96, 64, 4, seed=3)),
    "palette_alpha": lambda: _encoded(
        testimages.palette_alpha(96, 64, colors=40, seed=7)),
    "alpha_toggle": lambda: _encoded(testimages.alpha_toggle(96, 64)),
    "alpha_pull": _alpha_pull,
    "unwritten_index": _unwritten_index,
    "adversarial": lambda: _raw_stream(64, 32, 4, b"\x05" * (64 * 32)),
}


def _padded(stream: bytes):
    raw = np.frombuffer(stream, np.uint8)[fmt.HEADER_SIZE:]
    pad = np.zeros(M, np.uint8)
    pad[: len(raw)] = raw
    return pad, len(stream) - fmt.HEADER_SIZE - fmt.TRAILER_SIZE


# ---- scans.cummax ------------------------------------------------------

@pytest.mark.parametrize("shape", [(1,), (37,), (1000,), (3, 257)])
def test_cummax_matches_jax(shape):
    rng = np.random.default_rng(sum(shape))
    x = rng.integers(-1000, 1000, shape).astype(np.int32)
    assert_same(jscans.cummax(jnp.asarray(x)),
                tscans.cummax(torch.from_numpy(x)))


@pytest.mark.parametrize("n,density", [(1, 1.0), (37, 0.3), (1000, 0.05),
                                       (1000, 0.0)])
def test_last_mark_is_the_cummax_of_rising_marks(n, density):
    """The callers' count-and-scatter form equals the JAX cummax where the
    marked values rise with position."""
    rng = np.random.default_rng(n)
    marked = rng.random(n) < density
    vals = np.cumsum(rng.integers(1, 9, n))
    marks = np.where(marked, vals, -1).astype(np.int64)
    assert_same(jscans.cummax(jnp.asarray(marks.astype(np.int32))),
                tscans.last_mark(torch.from_numpy(marks)))


# ---- ops/link -----------------------------------------------------------

def _forest(n, c, seed, n_extra=0):
    """Seeded random forest: every real node points at an earlier node,
    the virtual root (-1) or, given extras, an extra node."""
    rng = np.random.default_rng(seed)
    span = rng.integers(1, 8, (n, c))
    parent = np.arange(n)[:, None] - span
    parent = np.where(parent < 0, -1, parent)
    if n_extra:
        to_extra = rng.random((n, c)) < 0.1
        parent = np.where(to_extra, n + rng.integers(0, n_extra, (n, c)),
                          parent)
    delta = rng.integers(0, 256, (n, c)).astype(np.uint8)
    anchored = rng.random((n, c)) < 0.2
    anchor = rng.integers(0, 256, (n, c)).astype(np.uint8)
    return parent.astype(np.int32), delta, anchored, anchor


@pytest.mark.parametrize("n", [1, 37, 1000])
def test_link_resolve_matches_jax(n):
    parent, delta, anchored, anchor = _forest(n, 4, n)
    root = np.array([0, 7, 200, 255], np.uint8)
    want = jlink.resolve(*(jnp.asarray(a) for a in (parent, delta, anchored,
                                                    anchor, root)))
    got = tlink.resolve(*(to_torch(a) for a in (parent, delta, anchored,
                                                anchor, root)))
    assert got.dtype == torch.uint8
    assert_same(want, got)


@pytest.mark.parametrize("n", [1, 37, 1000])
@pytest.mark.parametrize("n_extra", [1, 5])
def test_link_resolve_roots_matches_jax(n, n_extra):
    parent, delta, done0, _ = _forest(n, 4, 3 * n + n_extra, n_extra)
    want = jlink.resolve_roots(jnp.asarray(parent), jnp.asarray(delta),
                               jnp.asarray(done0), n_extra)
    got = tlink.resolve_roots(to_torch(parent), to_torch(delta),
                              to_torch(done0), n_extra)
    assert got[0].dtype == torch.int32 and got[1].dtype == torch.uint8
    for a, b in zip(want, got):
        assert_same(a, b)


# ---- table.table_replay --------------------------------------------------

@pytest.mark.parametrize("n", [1, 100, 1000])
@pytest.mark.parametrize("with_incoming", [False, True])
def test_table_replay_matches_jax(n, with_incoming):
    """query_keys differ from keys (the decoder's INDEX reads b1 & 63 and
    writes hash(px)); the incoming state has written and unwritten
    slots."""
    rng = np.random.default_rng(n + 7 * with_incoming)
    keys = rng.integers(0, 64, n).astype(np.int32)
    qkeys = rng.integers(0, 64, n).astype(np.int32)
    vals = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    write = rng.random(n) < 0.6
    inc = (rng.integers(0, 2**32, 64, dtype=np.uint64).astype(np.uint32),
           rng.random(64) < 0.5)
    want_before, (want_t, want_w) = jtable.table_replay(
        jnp.asarray(keys), jnp.asarray(vals), jnp.asarray(write),
        incoming=(tuple(jnp.asarray(a) for a in inc) if with_incoming
                  else None),
        query_keys=jnp.asarray(qkeys))
    before, (ft, fw) = ttable.table_replay(
        to_torch(keys), to_torch(vals.astype(np.int64)), to_torch(write),
        incoming=(tuple(to_torch(a) for a in inc) if with_incoming
                  else None),
        query_keys=to_torch(qkeys))
    assert_same(want_before, before)
    assert_same(want_t, ft)
    assert_same(want_w, fw)


def test_table_replay_defaults_query_keys_to_keys():
    rng = np.random.default_rng(3)
    keys = rng.integers(0, 64, 500).astype(np.int32)
    vals = rng.integers(0, 2**32, 500, dtype=np.uint64).astype(np.uint32)
    write = rng.random(500) < 0.5
    want = jtable.table_replay(jnp.asarray(keys), jnp.asarray(vals),
                               jnp.asarray(write))
    got = ttable.table_replay(to_torch(keys), to_torch(vals.astype(np.int64)),
                              to_torch(write))
    assert_same(want[0], got[0])
    for a, b in zip(want[1], got[1]):
        assert_same(a, b)


# ---- v1 stages ----------------------------------------------------------

@jax.jit
def _jax_stages(data, clen):
    """The JAX v1 stages before the fixpoint: chunk start positions, the
    valid mask, the chunk fields and the initial hashes."""
    m = data.shape[0]
    starts = jfsm.chunk_starts(data, clen)
    io = jnp.arange(m, dtype=jnp.int32)
    cid = jscans.exclusive_cumsum(starts.astype(jnp.int32))
    start_pos = jnp.full((m,), m - 1, jnp.int32).at[
        jnp.where(starts, cid, m)].set(io, mode="drop")
    valid = io < cid[-1] + starts[-1].astype(jnp.int32)
    f = jv1._chunk_fields(data, start_pos, valid)
    return start_pos, valid, f, jv1._initial_hashes(f, valid)


@pytest.fixture(scope="module")
def bodies():
    if not oracle.available():
        pytest.skip("oracle not built")
    return {name: _padded(make()) for name, make in STREAMS.items()}


@needs_oracle
@pytest.mark.parametrize("case", sorted(STREAMS))
def test_chunk_fields_and_initial_hashes_match_jax(bodies, case):
    pad, clen = bodies[case]
    start_pos, valid, f, hashes = _jax_stages(jnp.asarray(pad),
                                              jnp.int32(clen))
    tf = tv1._chunk_fields(to_torch(pad), to_torch(start_pos),
                           to_torch(valid))
    assert set(tf) == set(f)
    for k in f:
        assert_same(f[k], tf[k])
    assert_same(hashes, tv1._initial_hashes(tf, to_torch(valid)))


@needs_oracle
@pytest.mark.parametrize("case", sorted(STREAMS))
def test_decode_chunks_matches_jax(bodies, case):
    pad, clen = bodies[case]
    want, want_conv = jv1._decode_chunks_jit(jnp.asarray(pad),
                                             jnp.int32(clen), N_PX)
    got, conv, iters = tv1._decode_chunks(to_torch(pad), clen, N_PX)
    assert got.dtype == torch.uint8 and got.shape == (N_PX, 4)
    assert conv == bool(want_conv)
    assert 1 <= iters <= tv1._MAX_FIXPOINT_ITERS
    assert_same(want, got)


@needs_oracle
def test_decode_chunks_unconverged_matches_jax(bodies, monkeypatch):
    """Capped at one iteration, the adversarial stream does not converge;
    the final resolve from the last hashes is JAX's."""
    pad, clen = bodies["adversarial"]
    monkeypatch.setattr(jv1, "_MAX_FIXPOINT_ITERS", 1)
    monkeypatch.setattr(tv1, "_MAX_FIXPOINT_ITERS", 1)
    # a new function object traces afresh (jit caches by function), so
    # the trace reads the capped constant
    want, want_conv = jax.jit(lambda d, c: jv1._decode_chunks(d, c, N_PX))(
        jnp.asarray(pad), jnp.int32(clen))
    got, conv, iters = tv1._decode_chunks(to_torch(pad), clen, N_PX)
    assert not bool(want_conv) and not conv and iters == 1
    assert_same(want, got)


def test_bucket_sizes_match_jax():
    for n in (0, 1, 255, 256, 257, 5000, (1 << 20) - 1, 1 << 20,
              (1 << 20) + 1, 14_000_000, 1 << 24, (7 << 21) + 1):
        assert tv1.bucket_size(n) == jv1.bucket_size(n)
        assert tv1.bucket_size_fine(n) == jv1.bucket_size_fine(n)
        assert tv1.bucket_size(n, 4096) == jv1.bucket_size(n, 4096)


# ---- v1 decode against the oracle (tests/test_decode_pipeline.py) ------

def _roundtrip(img: np.ndarray) -> None:
    stream = _encoded(img)
    got, gdesc = tv1.decode(stream, device="cpu")
    want, wdesc = oracle.decode(stream)
    assert (gdesc.width, gdesc.height, gdesc.channels) == \
        (wdesc.width, wdesc.height, wdesc.channels)
    np.testing.assert_array_equal(got, want)


def _same_as_oracle(data: bytes, channels: int = 0) -> None:
    got, _ = tv1.decode(data, channels, device="cpu")
    np.testing.assert_array_equal(got, oracle.decode(data, channels)[0])


@needs_oracle
@pytest.mark.parametrize("name", sorted(testimages.edge_case_suite(4)))
def test_edge_cases_rgba(name):
    _roundtrip(testimages.edge_case_suite(4)[name])


@needs_oracle
@pytest.mark.parametrize("name", ["gradient", "palette", "mixed",
                                  "noise_small", "flat_70px"])
def test_edge_cases_rgb(name):
    _roundtrip(testimages.edge_case_suite(3)[name])


@needs_oracle
def test_alpha_varying_rgb_literals():
    rng = np.random.default_rng(5)
    img = rng.integers(0, 255, size=(8, 64, 4), dtype=np.uint8)
    img[..., 3] = 200
    img[0, 0, 3] = 130
    _roundtrip(img)


@needs_oracle
@pytest.mark.parametrize("ch", [3, 4])
def test_channel_forcing(ch):
    stream = _encoded(testimages.mixed(50, 20, ch))
    for channels in (0, 3, 4):
        _same_as_oracle(stream, channels)


@needs_oracle
def test_truncation_tolerance():
    full = _encoded(testimages.mixed(40, 30, 4))
    for cut in (0, 1, 7, len(full) - fmt.HEADER_SIZE - fmt.TRAILER_SIZE - 5):
        _same_as_oracle(full[: fmt.HEADER_SIZE + cut] + fmt.TRAILER)


@needs_oracle
def test_header_only_stream():
    _same_as_oracle(fmt.pack_header(fmt.StreamDesc(5, 4, 4)) + fmt.TRAILER)


@needs_oracle
@pytest.mark.parametrize("case", ["unwritten_index", "alpha_pull",
                                  "redundant_literals", "adversarial"])
def test_noncanonical_streams(case):
    """INDEX reads of never-written slots (the zero entry), RGB literals
    where an encoder would emit DIFF/RUN, alpha pulled through INDEX into
    an RGB literal's hash, and the adversarial stream, which v1 decodes
    on the device in two iterations."""
    if case == "redundant_literals":
        data = _raw_stream(7, 1, 3, bytes([fmt.OP_RGB, 10, 10, 10] * 4
                                          + [fmt.OP_RUN | 2]))
    else:
        data = STREAMS[case]()
    _same_as_oracle(data)


@needs_oracle
def test_random_roundtrips_many_sizes():
    rng = np.random.default_rng(0)
    for _ in range(6):
        w = int(rng.integers(1, 90))
        h = int(rng.integers(1, 40))
        ch = int(rng.choice([3, 4]))
        kind = int(rng.integers(0, 3))
        if kind == 0:
            img = testimages.noise(w, h, ch, seed=int(rng.integers(1 << 30)))
        elif kind == 1:
            img = testimages.palette(w, h, ch,
                                     seed=int(rng.integers(1 << 30)))
        else:
            img = testimages.gradient(w, h, ch)
        _roundtrip(img)


@needs_oracle
def test_unconverged_stream_falls_back_to_the_scan(monkeypatch):
    """A stream whose fixpoint does not converge goes to the sequential
    decoder, with the oracle's pixels."""
    from qoi_tpu_torch.models import scan_codec

    data = STREAMS["adversarial"]()
    monkeypatch.setattr(tv1, "_MAX_FIXPOINT_ITERS", 1)
    seen = []
    scan = scan_codec.decode
    monkeypatch.setattr(scan_codec, "decode",
                        lambda *a: seen.append(a[0]) or scan(*a))
    _same_as_oracle(data)
    assert seen == [data]


def test_decode_rejects_bad_channels():
    with pytest.raises(ValueError):
        tv1.decode(_unwritten_index(), 2, device="cpu")
