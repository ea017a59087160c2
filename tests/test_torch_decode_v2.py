"""qoi_tpu_torch's gather-free decoder v2 (models/decode_v2) and its
two-phase table query (table.table_select_local/carry) against the JAX
package on the CPU, and its decode against the C++ oracle. The tolerance
is exact equality everywhere (an integer codec)."""
import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qoi_tpu.models import decode_v2 as jv2
from qoi_tpu.ops import scans as jscans
from qoi_tpu.ops import table as jtable
from qoi_tpu.utils import testimages
from qoi_tpu_torch import format as fmt
from qoi_tpu_torch import oracle
from qoi_tpu_torch.kernels import blocked_scan as kbs
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
@pytest.mark.parametrize("case", sorted(STREAMS))
def test_round0_leaves_match_jax(bodies, case):
    """`stream_body` pads a stream's body to its bucket as `decode` does;
    the resolve scan of `round0_leaves` is JAX's round 0 (INDEX chunks
    reading the zero entry), and the bucket's leaves are a prefix of the
    longer padding's."""
    stream = STREAMS[case]()
    raw = np.frombuffer(stream, np.uint8)[fmt.HEADER_SIZE:]
    body, clen = tv2.stream_body(stream, "cpu")
    assert body.shape == (tv1.bucket_size(len(raw)),)
    assert clen == bodies[case][1]
    np.testing.assert_array_equal(body[: len(raw)].numpy(), raw)
    assert not body[len(raw):].any()
    pad, _ = bodies[case]
    flags, lit, deltas, _, _ = jv2._fields(jnp.asarray(pad), jnp.int32(clen))
    want = jv2._resolve_scan_wrap(flags, lit, deltas,
                                  jnp.zeros_like(lit, dtype=jnp.uint32),
                                  jnp.zeros_like(flags, dtype=bool))
    long_ = tv2.round0_leaves(to_torch(pad), clen)
    assert_same(want, kbs.resolve_scan(*long_))
    n = min(body.shape[0], M)
    for a, b in zip(tv2.round0_leaves(body, clen), long_):
        assert torch.equal(a[:, :n], b[:, :n])


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


# ---- resolve_scan: v2's reset-or-add scan and its kernel's design ---------

_M32 = 0xFFFFFFFF
_AGG, _INC = 1, 2
_SEED_PX = 0xFF000000

#: the kernel's geometry (csrc/blocked_scan.cu): threads a block and
#: 16-position lanes a thread
KERNEL_GEOMETRY = (256, 2)


def _comb_v(v1, v2, m2):
    """The kernel's resolve_comb on u32 words (uint64 arrays): the
    byte-wise sum of v1 & ~m2 and v2, low seven bits added and top bits
    by exclusive or."""
    a = v1 & ~m2 & _M32
    return (((a & 0x7F7F7F7F) + (v2 & 0x7F7F7F7F))
            ^ ((a ^ v2) & 0x80808080)) & _M32


def _rcomb(x, y):
    """(values, reset bytes) of y after x."""
    return _comb_v(x[0], y[0], y[1]), x[1] | y[1]


def _nz_bits(x):
    """Bit 0 of each byte set where the byte is not 0."""
    return ((x | ((x & 0x7F7F7F7F) + 0x7F7F7F7F)) >> 7) & 0x01010101


def _bytes_of(*words):
    """(n, 4 len(words)) uint8: the little-endian bytes of u32 arrays."""
    return np.stack(words, axis=-1).astype("<u4").view(np.uint8)


def _word_of(b):
    """(n, 4) uint8 -> (n,) u32 (uint64)."""
    return np.ascontiguousarray(b).view("<u4")[:, 0].astype(np.uint64)


def _sign_bytes(x):
    """prmt's sign mode: each byte its top bit, replicated."""
    return _word_of((_bytes_of(x) >> 7) * np.uint8(0xFF))


def _mask_bits(m):
    return ((m & 0x01010101) * 0x01020408 & _M32) >> 24


def _mask_bytes(b):
    return ((b * 0x00204081) & 0x01010101) * 0xFF


def _byte_perm(x, y, sel):
    """__byte_perm: byte n of the result is byte (sel >> 4n) & 7 of y:x."""
    return _word_of(_bytes_of(x, y)[:, [(sel >> (4 * n)) & 7
                                        for n in range(4)]])


def _transpose4(x0, x1, x2, x3):
    """The kernel's 4x4 byte transpose: out[k] byte c = x[c] byte k."""
    t0, t1 = _byte_perm(x0, x1, 0x5140), _byte_perm(x2, x3, 0x5140)
    t2, t3 = _byte_perm(x0, x1, 0x7362), _byte_perm(x2, x3, 0x7362)
    return [_byte_perm(t0, t1, 0x5410), _byte_perm(t0, t1, 0x7632),
            _byte_perm(t2, t3, 0x5410), _byte_perm(t2, t3, 0x7632)]


def _words(mem, at):
    """(lanes, 4) u32 little-endian words of the 16 bytes at each `at`."""
    b = mem[at[:, None] + np.arange(16)].astype(np.uint64)
    return (b.reshape(-1, 4, 4) << (8 * np.arange(4, dtype=np.uint64))
            ).sum(axis=2, dtype=np.uint64)


def _row16(mem, base, e, length, seen):
    """The kernel's row16 for lanes at positions e: bytes [e, e + 16) of
    the row at byte `base` of `mem` (at any alignment), zero from `length`
    on. The one or two 16-byte chunks from e - lead (a whole one as one
    load, an edge one byte by byte), then a funnel shift by lead."""
    lead = base & 15
    w = np.zeros((len(e), 8), np.uint64)
    for h in range(2 if lead else 1):
        b0 = e - lead + 16 * h
        whole = (b0 >= 0) & (b0 + 16 <= length)
        seen["chunk"] += int(whole.sum())
        idx = b0[:, None] + np.arange(16)
        ok = (idx >= 0) & (idx < length)
        b = np.where(ok, mem[base + np.clip(idx, 0, length - 1)], 0)
        w[:, 4 * h: 4 * h + 4] = (
            b.astype(np.uint64).reshape(-1, 4, 4)
            << (8 * np.arange(4, dtype=np.uint64))).sum(axis=2,
                                                        dtype=np.uint64)
    q, r = lead >> 2, 8 * (lead & 3)
    return np.stack([((w[:, k + q + 1] << 32 | w[:, k + q]) >> r) & _M32
                     for k in range(4)], axis=1)


def _resolve_by_design(rflag, val, threads=256, lanes=2, offset=0, seed=0,
                       inflight=6, start_p=0.3, late=0.0):
    """csrc/blocked_scan.cu's resolve_kernel in Python, all lanes of a
    tile at once: (4, M) uint8 rflag and val -> (4, M) uint8 and the
    counts of what ran. The inputs lie `offset` bytes into their buffers
    (rows off 16 bytes unless offset and M are multiples of 16), the
    output at a 16-byte boundary. Tiles of threads x lanes x 16
    positions, lane r of thread t at 16 (t + r threads), one a block,
    taken by ticket; at most `inflight` blocks at once (a new one started
    at a step with probability `start_p`), their steps interleaved by a
    seeded generator (with probability `late` the block on the latest
    tile steps: the later tiles run ahead). A lane's leaves: its 16-byte span of each row (a
    whole tile of aligned rows straight from memory, else `_row16`), the
    flags as 4 bits a position (fb[h] byte c bit i: position 8h + i),
    the values by one 4x4 transpose; folds by the SWAR combine with masks
    from prmt's sign mode; warp shuffles (warps of min(threads, 32)
    lanes) and the warp totals' scan; the status word flag << 62 | reset
    bits << 32 | values and warp 0's look-back over 32 tiles (the
    one-pass kernels' template: the window read again while a word
    before its first inclusive one is unpublished); the apply from the
    seed as a state that resets every channel; the rows back by
    the same transpose, as 16-byte stores where aligned and whole, else
    byte by byte."""
    m = rflag.shape[1]
    tile = threads * lanes * 16
    nt = -(-m // tile)
    fmem = np.zeros(4 * m + offset, np.uint8)
    vmem = np.zeros(4 * m + offset, np.uint8)
    fmem[offset:], vmem[offset:] = rflag.reshape(-1), val.reshape(-1)
    aligned = offset % 16 == 0 and m % 16 == 0
    out = np.full(4 * m, -1, np.int64)
    status = [0] * nt
    rng = np.random.default_rng(seed)
    seen = dict.fromkeys(("wait", "slide", "vec", "byte", "whole", "any",
                          "chunk", "tiles"), 0)
    nl = threads * lanes
    v_lane = np.arange(nl)
    t_of, r_of = v_lane % threads, v_lane // threads
    lane_of = t_of % 32
    g_of = r_of * -(-threads // 32) + t_of // 32   # warp of lanes, in order
    groups = int(g_of.max()) + 1
    last_of = np.array([np.nonzero(g_of == g)[0].max()
                        for g in range(groups)])
    ticket = [0]

    def take():
        ticket[0] += 1
        return ticket[0] - 1

    def leaves(j):
        e = j * tile + 16 * v_lane
        whole = aligned and (j + 1) * tile <= m
        seen["whole" if whole else "any"] += 1
        rows = []
        for c in range(8):
            mem, base = (fmem, vmem)[c >> 2], offset + (c & 3) * m
            rows.append(_words(mem, base + e) if whole
                        else _row16(mem, base, e, m, seen))
        fb = np.zeros((nl, 2), np.uint64)
        for c in range(4):
            for h in range(2):
                u = _nz_bits(rows[c][:, 2 * h]) | (
                    _nz_bits(rows[c][:, 2 * h + 1]) << 4)
                fb[:, h] |= (((u * 0x01020408) & _M32) >> 24) << (8 * c)
        v = np.zeros((nl, 16), np.uint64)
        for q in range(4):
            v[:, 4 * q: 4 * q + 4] = np.stack(_transpose4(
                *(rows[4 + c][:, q] for c in range(4))), axis=1)
        return v, fb, whole

    def mask(fb, k):
        return _sign_bytes((fb[:, k >> 3] << (7 - (k & 7))) & _M32)

    def shfl_up(x, d):
        """Each lane's x from lane - d of its warp (its own below d)."""
        src = np.where(lane_of >= d, v_lane - d, v_lane)
        return x[0][src], x[1][src]

    def word(flag, x):
        return flag << 62 | int(_mask_bits(int(x[1]))) << 32 | int(x[0])

    def unpack(w):
        return w >> 62, (w & _M32, int(_mask_bytes((w >> 32) & 0xF)))

    def look_back(j):
        hi, acc = j - 1, None
        while True:
            win = [unpack(status[hi - ln]) for ln in range(32)
                   if hi - ln >= 0]
            stops = [i for i, (f, _) in enumerate(win) if f != _AGG]
            if stops and win[stops[0]][0] == 0:
                seen["wait"] += 1
                yield
                continue
            last = stops[0] if stops else len(win) - 1
            w = win[last][1]
            for i in range(last - 1, -1, -1):
                w = _rcomb(w, win[i][1])
            acc = w if acc is None else _rcomb(w, acc)
            if stops:
                return acc
            seen["slide"] += 1
            hi -= 32
            yield

    def block(st):
        cur = st["cur"] = take()
        v, fb, whole = leaves(cur)
        seen["tiles"] += 1
        yield
        x = v[:, 0]
        for k in range(1, 16):
            x = _comb_v(x, v[:, k], mask(fb, k))
        inc = (x, _nz_bits(fb[:, 0] | fb[:, 1]) * 0xFF)
        for d in (1, 2, 4, 8, 16):
            y = shfl_up(inc, d)
            ok = lane_of >= d
            c = _rcomb(y, inc)
            inc = (np.where(ok, c[0], inc[0]), np.where(ok, c[1], inc[1]))
        wt = (inc[0][last_of].copy(), inc[1][last_of].copy())
        d = 1
        while d < groups:
            src = np.maximum(np.arange(groups) - d, 0)
            c = _rcomb((wt[0][src], wt[1][src]), wt)
            ok = np.arange(groups) >= d
            wt = (np.where(ok, c[0], wt[0]), np.where(ok, c[1], wt[1]))
            d *= 2
        agg = (wt[0][-1], wt[1][-1])
        ex = None
        if cur == 0:
            status[cur] = word(_INC, agg)
        else:
            status[cur] = word(_AGG, agg)
            yield
            ex = yield from look_back(cur)
            status[cur] = word(_INC, _rcomb(ex, agg))
        # each lane's prefix: the tile's, then its own in the tile
        up = shfl_up(inc, 1)
        first = lane_of == 0
        gm1 = np.maximum(g_of - 1, 0)
        pw = (wt[0][gm1], wt[1][gm1])
        both = _rcomb(pw, up)
        p = (np.where(first, pw[0], both[0]),
             np.where(first, pw[1], both[1]))
        p = (np.where(g_of > 0, p[0], up[0]),
             np.where(g_of > 0, p[1], up[1]))
        has = (lane_of > 0) | (g_of > 0)
        if ex is not None:
            both = _rcomb((np.full(nl, ex[0], np.uint64),
                           np.full(nl, ex[1], np.uint64)), p)
            p = (np.where(has, both[0], np.uint64(ex[0])),
                 np.where(has, both[1], np.uint64(ex[1])))
            has = np.ones(nl, bool)
        acc = np.where(has, _comb_v(np.uint64(_SEED_PX), p[0], p[1]),
                       np.uint64(_SEED_PX))
        px = np.zeros((nl, 16), np.uint64)
        for k in range(16):
            acc = _comb_v(acc, v[:, k], mask(fb, k))
            px[:, k] = acc
        rows = np.zeros((4, nl, 16), np.int64)
        for q in range(4):
            for c, wd in enumerate(_transpose4(
                    *(px[:, 4 * q + i] for i in range(4)))):
                for b in range(4):
                    rows[c, :, 4 * q + b] = (wd >> (8 * b)) & 0xFF
        e = cur * tile + 16 * v_lane
        pos = e[:, None] + np.arange(16)
        for c in range(4):
            dst = c * m + e
            vec = (e + 16 <= m) & (dst % 16 == 0)
            assert not whole or vec.all()
            seen["vec"] += int(vec.sum())
            seen["byte"] += int((~vec & (e < m)).sum())
            ok = pos < m
            out[c * m + pos[ok]] = rows[c][ok]
        if rng.random() < 0.5:
            yield

    running, started, steps = [], 0, 0
    while started < nt or running:
        steps += 1
        assert steps < 10 ** 6, "the blocks stopped making progress"
        if started < nt and len(running) < inflight and (
                not running or rng.random() < start_p):
            st = {"cur": -1}
            running.append((block(st), st))
            started += 1
            continue
        if rng.random() < late:
            co = max(running, key=lambda b: b[1]["cur"])
        else:
            co = running[int(rng.integers(len(running)))]
        try:
            next(co[0])
        except StopIteration:
            running.remove(co)
    assert (out >= 0).all(), "an output byte was never stored"
    assert seen["tiles"] == nt
    return out.astype(np.uint8).reshape(4, m), seen


@jax.jit
def _jax_resolve_jit(rflag, val):
    def combine(a, bb):
        ra, va = a
        rb, vb = bb
        return jnp.maximum(ra, rb), jnp.where(rb != 0, vb, va + vb)

    rs, vs = jscans.blocked_scan(combine, (rflag, val))
    seed = jnp.asarray(np.array(fmt.SEED_PIXEL, np.uint8))[:, None]
    return jnp.where(rs != 0, vs, seed + vs)


def _jax_resolve(rflag, val):
    """JAX's blocked_scan of v2's combine and the seed epilogue
    (qoi_tpu/models/decode_v2.py:141-147) on the same leaves, jitted. A
    scan's prefix does not depend on what follows it, so the leaves are
    padded with zeros to one of two lengths (one program each): 2048, in
    JAX's associative_scan branch, or 32768, in its blocked lax.scan."""
    m = rflag.shape[1]
    n = 2048 if m <= 2048 else 32768
    assert m <= n
    pad = [(0, 0), (0, n - m)]
    return np.asarray(_jax_resolve_jit(np.pad(rflag, pad),
                                       np.pad(val, pad)))[:, :m]


def _resolve_case(name):
    """(rflag, val) (4, M) uint8 of a named case: random values of every
    byte (adds wrap mod 256) under sparse resets of RGB only, alpha only
    or both; `edges` puts them at tile edges of 64-position tiles; `odd`
    has flag bytes of 1, 2, 0x80 and 0xFF among zeros (any nonzero byte
    resets); the photo case is a slice of a photo stream's round-0
    leaves."""
    if name == "photo_slice":
        body, clen = _padded(_encoded(testimages.photo(160, 96, 4, seed=3)))
        data = torch.from_numpy(body)
        flags, lit, deltas, _, _ = tv2._fields(data, clen)
        f = tv2._unpack_flags(flags)
        rflag, val = tv2._resolve_leaves(f, lit, deltas,
                                         torch.zeros_like(lit),
                                         torch.zeros_like(f["starts"]))
        return rflag[:, :20001].numpy(), val[:, :20001].numpy()
    m = int(name.split("_")[1])
    rng = np.random.default_rng(m)
    if name.startswith("odd"):
        f = rng.choice(np.array([0] * 12 + [1, 2, 0x80, 0xFF], np.uint8),
                       (4, m))
        return f, rng.integers(0, 256, (4, m), dtype=np.uint8)
    rgb = rng.random(m) < 0.01
    alpha = rng.random(m) < 0.005
    if name.startswith("edges"):
        rgb[:] = alpha[:] = False
        rgb[63::128] = True           # RGB only, at a tile's last position
        alpha[64::192] = True         # alpha only, at a tile's first
        rgb[127::256] = alpha[127::256] = True    # both
    f = np.stack([rgb, rgb, rgb, alpha]).astype(np.uint8)
    return f, rng.integers(0, 256, (4, m), dtype=np.uint8)


def _geometry(g):
    """(threads, lanes) of a case's geometry: threads (one lane) or
    "TxL"."""
    if isinstance(g, int):
        return g, 1
    t, l_ = g.split("x")
    return int(t), int(l_)


#: (case, geometry, input offset): threads a block (one 16-position lane
#: a thread) or "TxL". The kernel's geometry (256x2, 8192-position tiles)
#: at t - 1, t, t + 1, 3t + 16 (a ragged last tile of aligned rows), on
#: rows off 16 bytes (offset 5) and on flag bytes other than 1; one lane
#: a thread (256x1, 4096-position tiles) at its own edges, and 512
#: threads at 1, 17, 4095 and 4097 positions and on a photo stream's
#: slice; 128x2; 64-position tiles (4 threads, 2x2), many in flight,
#: whose look-back waits and slides past 32 tiles
RESOLVE_CASES = [("rand_1", 512, 0), ("rand_17", 512, 5),
                 ("rand_4095", 512, 0), ("rand_4097", 512, 5),
                 ("photo_slice", 512, 0), ("edges_4097", 4, 0),
                 ("rand_4095", 4, 5),
                 ("rand_4095", "256x1", 0), ("rand_4096", "256x1", 0),
                 ("rand_4097", "256x1", 0), ("rand_4096", "256x1", 5),
                 ("rand_12304", "256x1", 0), ("odd_8208", "256x1", 0),
                 ("rand_6000", "128x2", 0), ("odd_4097", "2x2", 3),
                 ("odd_10500", 4, 0),
                 ("rand_8191", "256x2", 0), ("rand_8192", "256x2", 0),
                 ("rand_8193", "256x2", 0), ("rand_8192", "256x2", 5),
                 ("rand_24592", "256x2", 0), ("odd_16400", "256x2", 0)]


@pytest.mark.parametrize("case,threads,offset", RESOLVE_CASES)
def test_resolve_scan_design_matches_jax(case, threads, offset):
    """The model of the kernel, the twin (and the wrapper's CPU route)
    and JAX's blocked_scan give the same px after every byte."""
    rflag, val = _resolve_case(case)
    want = _jax_resolve(rflag, val)
    t, lanes = _geometry(threads)
    small = t * lanes * 16 <= 64
    # the small tiles in seeded interleavings, 48 and 200 in flight,
    # started in bursts, the later tiles run ahead: look-backs wait, and
    # windows of aggregates slide
    runs = [dict(seed=len(case))]
    if small:
        burst = dict(start_p=0.95, late=0.8)
        runs = [dict(burst, seed=0, inflight=48),
                dict(burst, seed=1, inflight=200)]
    total = {"wait": 0, "slide": 0}
    for run in runs:
        got, seen = _resolve_by_design(rflag, val, t, lanes, offset, **run)
        np.testing.assert_array_equal(got, want)
        for k in total:
            total[k] += seen[k]
    twin = kbs.resolve_scan_plain(torch.from_numpy(rflag),
                                  torch.from_numpy(val))
    np.testing.assert_array_equal(twin.numpy(), want)
    np.testing.assert_array_equal(
        kbs.resolve_scan(torch.from_numpy(rflag),
                         torch.from_numpy(val)).numpy(), want)
    m = rflag.shape[1]
    if small:
        assert total["slide"] > 0 and total["wait"] > 0, total
    if m % 16 or offset % 16:
        assert seen["whole"] == 0 and seen["any"] > 0, seen
        assert seen["byte"] > 0 or m % 16 == 0, seen
    elif m >= t * lanes * 16:
        assert seen["whole"] > 0 and seen["vec"] > 0, seen


def test_resolve_scan_model_geometry_is_the_kernels():
    """The model's geometry, TILE_RESOLVE and the kernel source's
    geometry agree."""
    src = (pathlib.Path(kbs.__file__).parent.parent / "csrc"
           / "blocked_scan.cu").read_text()
    threads = int(re.search(r"constexpr int kRThreads = (\d+);", src)[1])
    lanes = int(re.search(r"constexpr int kRLanes = (\d+);", src)[1])
    assert (threads, lanes) == KERNEL_GEOMETRY
    assert threads * lanes * 16 == kbs.TILE_RESOLVE


def test_resolve_scan_wrapper_refuses_bad_shapes():
    z = torch.zeros((4, 8), dtype=torch.uint8)
    with pytest.raises(ValueError, match="channels"):
        kbs.resolve_scan(z[:3], z[:3])
    with pytest.raises(ValueError, match="shape"):
        kbs.resolve_scan(z, z[:, :7])
    with pytest.raises(TypeError, match="dtype"):
        kbs.resolve_scan(z, z.to(torch.int32))
