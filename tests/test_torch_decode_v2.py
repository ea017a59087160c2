"""qoi_tpu_torch's gather-free decoder v2 (models/decode_v2) and its
two-phase table query (table.table_select_local/carry) against the JAX
package on the CPU, and its decode against the C++ oracle. The tolerance
is exact equality everywhere (an integer codec)."""
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


def _vadd4(a, b):
    """Byte-wise add mod 256, as the SWAR form without carries between
    bytes (the kernel's __vadd4)."""
    return (((a & 0x7F7F7F7F) + (b & 0x7F7F7F7F)) ^ ((a ^ b) & 0x80808080))


def _comb(x, y):
    """(values, reset bytes) of y after x: where y resets, its value, else
    the byte-wise sum."""
    (va, ma), (vb, mb) = x, y
    return (vb & mb) | (_vadd4(va, vb) & ~mb & _M32), ma | mb


def _mask_bits(m):
    return ((m & 0x01010101) * 0x01020408 & _M32) >> 24


def _mask_bytes(b):
    return ((b * 0x00204081) & 0x01010101) * 0xFF


def _transpose4(x):
    """(4,) u32 -> (4,) u32: out[k] byte c = x[c] byte k."""
    return [sum(((x[c] >> 8 * k) & 0xFF) << 8 * c for c in range(4))
            for k in range(4)]


def _resolve_by_design(rflag, val, threads=512, offset=0, seed=0,
                       inflight=6, start_p=0.3):
    """csrc/blocked_scan.cu's resolve scan in Python: (4, M) uint8 rflag
    and val -> (4, M) uint8 and the look-back's counts. Tiles of `threads`
    x 16 positions (the kernel: 512) are taken by ticket, at most
    `inflight` at once (a new one started at a step with probability
    `start_p`), their steps interleaved by a seeded generator; a thread's
    leaves come from four 16-byte rows of each input transposed 4x4
    bytes at a time (flags to 0xFF bytes), folded by the SWAR combine;
    the block scans its threads' folds by warp shuffles and warp totals;
    the status word is flag << 62 | reset bits << 32 | values, and warp
    0's look-back reads 32 tiles at a time. The output goes to a flat
    (4M,) buffer `offset` bytes into its allocation, rows as 16-byte
    stores where aligned and whole, else byte by byte."""
    m = rflag.shape[1]
    tile = threads * 16
    nt = -(-m // tile)
    fl = np.zeros((4, nt * tile), np.int64)
    vl = np.zeros((4, nt * tile), np.int64)
    fl[:, :m], vl[:, :m] = rflag, val
    out = np.full(4 * m, -1, np.int64)
    status = [0] * nt
    rng = np.random.default_rng(seed)
    seen = {"wait": 0, "slide": 0, "vec": 0, "byte": 0}

    def unpack(word):
        return word >> 62, (word & _M32, _mask_bytes((word >> 32) & 0xF))

    def leaves(e):
        """The 16 (values, reset bytes) of the thread at position e."""
        got = []
        for q in range(4):
            pos = e + 4 * q
            fw = [int(sum(int(fl[c, pos + k]) << 8 * k for k in range(4)))
                  for c in range(4)]
            vw = [int(sum(int(vl[c, pos + k]) << 8 * k for k in range(4)))
                  for c in range(4)]
            for f, v in zip(_transpose4(fw), _transpose4(vw)):
                mask = sum(0xFF << 8 * c for c in range(4)
                           if (f >> 8 * c) & 0xFF)
                got.append((v, mask))
        return got

    def block(j):
        first = j * tile
        lv = [leaves(first + 16 * t) for t in range(threads)]
        folds = []
        for ls in lv:
            x = ls[0]
            for y in ls[1:]:
                x = _comb(x, y)
            folds.append(x)
        # warp shuffles (inclusive), then the warp totals' scan
        inc = list(folds)
        for w0 in range(0, threads, 32):
            lanes = range(w0, min(w0 + 32, threads))
            d = 1
            while d < 32:
                prev = list(inc)
                for t in lanes:
                    if t - w0 >= d:
                        inc[t] = _comb(prev[t - d], prev[t])
                d *= 2
        totals = [inc[min(w0 + 31, threads - 1)]
                  for w0 in range(0, threads, 32)]
        for w in range(1, len(totals)):
            totals[w] = _comb(totals[w - 1], totals[w])
        for t in range(32, threads):
            inc[t] = _comb(totals[t // 32 - 1], inc[t])
        agg = totals[-1]

        def word(flag, x):
            return flag << 62 | _mask_bits(x[1]) << 32 | x[0]

        status[j] = word(_INC if j == 0 else _AGG, agg)
        yield
        ex = None
        if j > 0:
            hi, acc = j - 1, None
            while True:
                win = [unpack(status[hi - ln]) for ln in range(32)
                       if hi - ln >= 0]
                flags = [f for f, _ in win]
                stops = [i for i, f in enumerate(flags) if f != _AGG]
                if stops and flags[stops[0]] == 0:
                    seen["wait"] += 1
                    yield
                    continue
                last = stops[0] if stops else len(win) - 1
                w = win[last][1]
                for i in range(last - 1, -1, -1):
                    w = _comb(w, win[i][1])
                acc = w if acc is None else _comb(w, acc)
                if stops:
                    break
                seen["slide"] += 1
                hi -= 32
                yield
            ex = acc
            status[j] = word(_INC, _comb(ex, agg))
        # apply from each thread's exclusive prefix; store the rows
        for t in range(threads):
            e = first + 16 * t
            pre = inc[t - 1] if t else None
            if ex is not None:
                pre = ex if pre is None else _comb(ex, pre)
            o = []
            for k, y in enumerate(lv[t]):
                pre = y if pre is None else _comb(pre, y)
                o.append((pre[0] & pre[1])
                         | (_vadd4(0xFF000000, pre[0]) & ~pre[1] & _M32))
            rows = [[], [], [], []]
            for q in range(4):
                for c, wd in enumerate(_transpose4(o[4 * q: 4 * q + 4])):
                    rows[c] += [(wd >> 8 * b) & 0xFF for b in range(4)]
            for c in range(4):
                dst = c * m + e
                if e + 16 <= m and (offset + dst) % 16 == 0:
                    assert dst + 16 <= (c + 1) * m
                    out[dst: dst + 16] = rows[c]
                    seen["vec"] += 1
                else:
                    for k in range(16):
                        if e + k < m:
                            out[dst + k] = rows[c][k]
                    seen["byte"] += 1
        if rng.random() < 0.5:
            yield

    pending, running = list(range(nt)), []
    while pending or running:
        if pending and len(running) < inflight and (
                not running or rng.random() < start_p):
            running.append(block(pending.pop(0)))
            continue
        co = running[int(rng.integers(len(running)))]
        try:
            next(co)
        except StopIteration:
            running.remove(co)
    assert (out >= 0).all(), "an output byte was never stored"
    return out.astype(np.uint8).reshape(4, m), seen


def _jax_resolve(rflag, val):
    """JAX's blocked_scan of v2's combine and the seed epilogue
    (qoi_tpu/models/decode_v2.py:141-147) on the same leaves."""
    def combine(a, bb):
        ra, va = a
        rb, vb = bb
        return jnp.maximum(ra, rb), jnp.where(rb != 0, vb, va + vb)

    rs, vs = jscans.blocked_scan(combine, (jnp.asarray(rflag),
                                           jnp.asarray(val)))
    seed = jnp.asarray(np.array(fmt.SEED_PIXEL, np.uint8))[:, None]
    return np.asarray(jnp.where(rs != 0, vs, seed + vs))


def _resolve_case(name):
    """(rflag, val) (4, M) uint8 of a named case: random values of every
    byte (adds wrap mod 256) under sparse resets of RGB only, alpha only
    or both; `edges` puts them at tile edges of 64-position tiles; the
    photo case is a slice of a photo stream's round-0 leaves."""
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
    rgb = rng.random(m) < 0.01
    alpha = rng.random(m) < 0.005
    if name.startswith("edges"):
        rgb[:] = alpha[:] = False
        rgb[63::128] = True           # RGB only, at a tile's last position
        alpha[64::192] = True         # alpha only, at a tile's first
        rgb[127::256] = alpha[127::256] = True    # both
    f = np.stack([rgb, rgb, rgb, alpha]).astype(np.uint8)
    return f, rng.integers(0, 256, (4, m), dtype=np.uint8)


#: (case, threads a model tile, output offset): the kernel's geometry at
#: 1, 17, 4095 and 4097 positions and on a photo stream's slice (three
#: tiles), and 64-position tiles, 48 in flight, whose look-back waits and
#: slides past 32 tiles
RESOLVE_CASES = [("rand_1", 512, 0), ("rand_17", 512, 5),
                 ("rand_4095", 512, 0), ("rand_4097", 512, 5),
                 ("photo_slice", 512, 0), ("edges_4097", 4, 0),
                 ("rand_4095", 4, 5)]


@pytest.mark.parametrize("case,threads,offset", RESOLVE_CASES)
def test_resolve_scan_design_matches_jax(case, threads, offset):
    """The model of the kernel, the twin (and the wrapper's CPU route)
    and JAX's blocked_scan give the same px after every byte."""
    rflag, val = _resolve_case(case)
    want = _jax_resolve(rflag, val)
    # the small tiles in three seeded interleavings, 48 in flight and
    # started in bursts
    total = {"wait": 0, "slide": 0}
    for seed in (range(3) if threads == 4 else [len(case)]):
        got, seen = _resolve_by_design(
            rflag, val, threads, offset, seed=seed,
            **({} if threads == 512 else dict(inflight=48, start_p=0.95)))
        np.testing.assert_array_equal(got, want)
        for k in total:
            total[k] += seen[k]
    twin = kbs.resolve_scan_plain(torch.from_numpy(rflag),
                                  torch.from_numpy(val))
    np.testing.assert_array_equal(twin.numpy(), want)
    np.testing.assert_array_equal(
        kbs.resolve_scan(torch.from_numpy(rflag),
                         torch.from_numpy(val)).numpy(), want)
    if threads == 4:
        assert total["slide"] > 0 and total["wait"] > 0, total
    if case == "rand_4097":
        assert seen["byte"] > 0


def test_resolve_scan_wrapper_refuses_bad_shapes():
    z = torch.zeros((4, 8), dtype=torch.uint8)
    with pytest.raises(ValueError, match="channels"):
        kbs.resolve_scan(z[:3], z[:3])
    with pytest.raises(ValueError, match="shape"):
        kbs.resolve_scan(z, z[:, :7])
    with pytest.raises(TypeError, match="dtype"):
        kbs.resolve_scan(z, z.to(torch.int32))
