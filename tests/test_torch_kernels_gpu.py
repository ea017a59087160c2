"""The CUDA kernels of qoi_tpu_torch against their plain PyTorch twins, on
the card. Results must be exactly equal (integer kernels).

These tests need a CUDA device and skip without one. The repository's
conftest imports jax, which the GPU machine need not have, so run them
there with:

    python -m pytest --noconftest -m gpu tests/test_torch_kernels_gpu.py -q
"""
import numpy as np
import pytest
import torch

import qoi_tpu_torch
from qoi_tpu_torch import format as fmt
from qoi_tpu_torch import oracle
from qoi_tpu_torch._bits import to_i32
from qoi_tpu_torch.kernels import _build
from qoi_tpu_torch.kernels import block_maps as kbm
from qoi_tpu_torch.kernels import blocked_scan as kbs
from qoi_tpu_torch.kernels import compact_words as kcw
from qoi_tpu_torch.kernels import encode_stage as kstage
from qoi_tpu_torch.kernels import expand as kexp
from qoi_tpu_torch.kernels import numeric_scan as kns
from qoi_tpu_torch.kernels import pack as kpack
from qoi_tpu_torch.kernels import scan_codec as kscan
from qoi_tpu_torch.kernels import slide as kslide
from qoi_tpu_torch.models import (decode_pipeline, decode_v2, decode_v3,
                                  pipeline, scan_codec)
from qoi_tpu_torch.ops import compact
from qoi_tpu_torch.utils import testimages
from compact_cases import CASES as COMPACT_CASES
from compact_cases import case as compact_case
from numeric_scan_cases import (all_index_planes, deep_chain_planes,
                                random_planes)
from scan_cases import (DECODE_CASES, ENCODE_CASES, decode_case,
                        encode_case, random_state)

pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _same(got, want):
    torch.cuda.synchronize()
    assert got.dtype == want.dtype == torch.int32
    assert got.shape == want.shape
    assert torch.equal(got.cpu(), want.cpu())


def _records(n, kind, seed):
    rng = np.random.default_rng(seed)
    if kind == "mixed":
        lens = rng.integers(0, 7, n)
    elif kind == "dense6":
        lens = np.full(n, 6)
        lens[-1] = 5
    elif kind == "sparse":
        lens = np.where(rng.random(n) < 0.05, rng.integers(1, 7, n), 0)
    else:
        lens = np.zeros(n, np.int64)
    b = rng.integers(1, 256, (n, 6)).astype(np.int64)
    b = np.where(np.arange(6)[None, :] < lens[:, None], b, 0)
    lo = b[:, 0] | b[:, 1] << 8 | b[:, 2] << 16 | b[:, 3] << 24
    hi = b[:, 4] | b[:, 5] << 8
    return (torch.from_numpy(lo), torch.from_numpy(hi),
            torch.from_numpy(lens.astype(np.int64)))


@pytest.mark.parametrize("n,kind,seg", [
    (20480 * 3 + 77, "mixed", 20480),   # ragged: padded last row
    (4096 * 2, "dense6", 4096),
    (5000, "sparse", 1024),
    (300, "empty", 4096),               # one row, no events
])
def test_slide_kernel_matches_twin(dev, n, kind, seg):
    ev = compact.wordsum_events(*(t.to(dev) for t in _records(n, kind, n)),
                                seg)
    val, aux = to_i32(ev.val), ev.aux.to(torch.int32)
    _same(kslide.slide_val(val, aux), kslide.slide_val_plain(val, aux))


@pytest.mark.parametrize("n,kind", [
    (20480 * 2 + 5, "mixed"), (4096, "dense6"), (64, "empty")])
def test_compact_on_card_matches_cpu(dev, n, kind):
    """Words and total (incl. total == 0) through the compaction kernel
    equal the CPU path through the slide's twin."""
    recs = _records(n, kind, 7 * n)
    cap = -(-n * 6 // 4) * 4
    wc, tc = compact.compact_words6_wordsum(*recs, cap, seg=20480)
    wg, tg = compact.compact_words6_wordsum(*(t.to(dev) for t in recs),
                                            cap, seg=20480)
    assert int(tg) == int(tc)
    _same(wg, wc)


@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("name", sorted(COMPACT_CASES))
def test_compact_words_kernel_matches_cpu(dev, name, dtype):
    """compact_words6_wordsum on the card, one compact_words launch and no
    slide, equals its CPU route over the whole (capacity // 4,) buffer, on
    int32 bit patterns (the staging kernel's form) and int64 u32 values,
    at the kernel's tile edges (tests/compact_cases.py)."""
    lo, hi, lens, cap = compact_case(name)
    wc, tc = compact.compact_words6_wordsum(lo, hi, lens, cap)
    if dtype == torch.int32:
        lo = to_i32(lo)
    _build.reset_launches()
    wg, tg = compact.compact_words6_wordsum(
        *(t.to(dtype).to(dev) for t in (lo, hi, lens)), cap)
    torch.cuda.synchronize()
    assert _build.launches["compact_words"] == 1
    assert _build.launches["slide_val"] == 0
    assert tg.device == wg.device == dev and tg.dtype == torch.int64
    assert int(tg) == int(tc)
    _same(wg, wc)


def test_compact_words_4k_frame_one_launch(dev):
    """The 4K mixed frame through encode_device_wordsum: one compact_words
    launch and no slide_val launch an encode, the words equal the CPU
    route's on the same records and the oracle's stream, and 100 launches
    give the first one's words bit for bit."""
    w, h = 3840, 2160
    img = testimages.mixed(w, h, 4, seed=3)
    want = oracle.encode(img, fmt.StreamDesc(w, h, 4))
    n = w * h
    px4 = torch.from_numpy(img.reshape(-1, 4).copy()).to(dev)
    _build.reset_launches()
    words, tot = pipeline.encode_device_wordsum(px4, n)
    torch.cuda.synchronize()
    assert _build.launches["compact_words"] == 1
    assert _build.launches["slide_val"] == 0
    got = (fmt.pack_header(fmt.StreamDesc(w, h, 4))
           + words.view(torch.uint8)[:int(tot)].cpu().numpy().tobytes()
           + fmt.TRAILER)
    assert got == want
    ch = pipeline.encode_stage_chunks(px4, n)
    wc, tc = compact.compact_words6_wordsum(
        ch.lo.cpu(), ch.hi.cpu(), ch.lens.cpu(), n * 6, seg=20480)
    assert int(tc) == int(tot)
    _same(words, wc)
    runs = [kcw.compact_words(ch.lo, ch.hi, ch.lens, n * 6)
            for _ in range(100)]
    torch.cuda.synchronize()
    for r, t in runs:
        assert torch.equal(r, words) and int(t) == int(tot)


def _expand_records(m, seed, max_run=62, first=0):
    """Per-byte (pix_off, px32) with pixel offsets from `first` on."""
    rng = np.random.default_rng(seed)
    npix = np.zeros(m, np.int64)
    px = np.zeros(m, np.uint32)
    i = 0
    while i < m:
        nbytes = int(rng.choice([1, 2, 4, 5]))
        npix[i] = int(rng.integers(1, max_run + 1)) if nbytes == 1 else 1
        px[i:i + nbytes] = np.uint32(rng.integers(0, 2**32))
        i += nbytes
    pix_off = (first + np.cumsum(npix) - npix).astype(np.int32)
    return torch.from_numpy(pix_off), torch.from_numpy(px.view(np.int32))


@pytest.mark.parametrize("m,cap,seed,max_run,first", [
    (600, 512, 0, 62, 0),       # truncation: offsets overflow the cap
    (100, 2048, 2, 62, 0),      # tail repeats the last chunk's px
    (70000, 65536, 3, 62, 0),
    (200000, 262144, 4, 1, 0),  # no runs: every chunk one pixel
    # runs straddle the 256-byte thread blocks; cap not a multiple of one
    (256 * 6 + 3, 256 * 40 + 77, 5, 62, 0),
    (5000, 400000, 6, 62, 150000),       # long seed prefix
    (3000, 5_000_000 + 13, 7, 62, 0),    # truncated: ~4.9 M-pixel tail
])
def test_expand_kernel_matches_twin(dev, m, cap, seed, max_run, first):
    pix_off, px = (t.to(dev) for t in _expand_records(m, seed, max_run,
                                                      first))
    _same(kexp.expand_px(pix_off, px, cap),
          kexp.expand_px_xla(pix_off, px, cap))


@pytest.mark.parametrize("seed32", [0, 0x01020304, 0xFFFFFFFF])
def test_expand_kernel_chained_seed(dev, seed32):
    """A streamed tile's expand takes its entry px as the seed: pixels
    before the first chunk keep it."""
    pix_off, px = (t.to(dev) for t in _expand_records(5000, 8, 62, 300))
    for cap in (4096, 400000):
        _same(kexp.expand_px(pix_off, px, cap, seed32=seed32),
              kexp.expand_px_xla(pix_off, px, cap, seed32=seed32))


def test_expand_kernel_empty_stream(dev):
    z = torch.zeros(0, dtype=torch.int32, device=dev)
    _same(kexp.expand_px(z, z, 100), kexp.expand_px_xla(z, z, 100))


def _stream_planes(img, dev):
    h, w, ch = img.shape
    s = oracle.encode(img, fmt.StreamDesc(w, h, ch))
    raw = np.frombuffer(s, np.uint8)[fmt.HEADER_SIZE:]
    m = decode_pipeline.bucket_size(len(raw))
    pad = np.zeros(m, np.uint8)
    pad[: len(raw)] = raw
    b = decode_v3._scan_block_len(m)
    starts, cls, r6, d32, lit32, npix = decode_v3._fields(
        torch.from_numpy(pad).to(dev), len(s) - 22)
    w0, _ = decode_v3._initial_w(cls, r6, d32, lit32, npix)
    w0 = torch.where(starts, w0, 0)
    pm = lambda x: decode_v3._pos_major(x, m, b)
    return (pm((cls | (r6 << 9) | (w0 << 3)).to(torch.int32)),
            pm(to_i32(d32)), pm(to_i32(lit32)))


@pytest.mark.parametrize("case,b,nb", [
    ("mixed", None, None), ("palette_alpha", None, None)] + [
    ("random", b, nb) for b in (16, 32, 96, 8192) for nb in (1, 7, 77, 1792)])
def test_block_maps_kernel_matches_twin(dev, case, b, nb):
    """The random planes have every class on random slots, so INDEX
    chains cross the kernel's segment edges. The kernel cuts a lane into
    12 segments: unequal at b = 32 and 8192, some empty at b = 16 and 32.
    nb = 1, 7 and 77 leave part of a 16-lane block empty."""
    if case == "random":
        rng = np.random.default_rng(1)
        cls = rng.integers(0, 5, (b, nb))
        meta = torch.from_numpy(
            (cls | rng.integers(0, 64, (b, nb)) << 3).astype(np.int32))
        d32, lit32 = (torch.from_numpy(rng.integers(
            -2**31, 2**31, (b, nb)).astype(np.int32)) for _ in range(2))
        planes = (meta.to(dev), d32.to(dev), lit32.to(dev))
    else:
        img = (testimages.mixed(200, 120, 4) if case == "mixed"
               else testimages.palette_alpha(160, 90))
        planes = _stream_planes(img, dev)
    for got, want in zip(kbm.block_maps(*planes),
                         kbm.block_maps_plain(*planes)):
        _same(got, want)


def test_block_maps_kernel_surgical_shape(dev):
    """The surgical round's narrow pass 1: 64 block lanes of 8192
    positions."""
    rng = np.random.default_rng(9)
    meta = (rng.integers(0, 5, (8192, 64))
            | rng.integers(0, 64, (8192, 64)) << 3).astype(np.int32)
    d32, lit32 = (rng.integers(-2**31, 2**31, (8192, 64)).astype(np.int32)
                  for _ in range(2))
    planes = [torch.from_numpy(x).to(dev) for x in (meta, d32, lit32)]
    for got, want in zip(kbm.block_maps(*planes),
                         kbm.block_maps_plain(*planes)):
        _same(got, want)


@pytest.mark.parametrize("case,w,h", [
    ("mixed", 160, 96), ("palette_alpha", 160, 96), ("mixed", 1920, 1080)])
def test_numeric_scan_kernel_matches_twin(dev, case, w, h):
    """A stream's round-1 planes and block entry states (from the seed,
    then from a random entry state): px after every position and the exit
    state. At 1080p the twin walks 8192 positions of 512 lanes."""
    img = (testimages.mixed(w, h, 4) if case == "mixed"
           else testimages.palette_alpha(w, h))
    planes = _stream_planes(img, dev)
    root, val, _, _ = kbm.block_maps(*planes)
    rng = np.random.default_rng(w)
    e65 = torch.from_numpy(rng.integers(0, 2**32, 65, dtype=np.uint64)
                           .astype(np.int64)).to(dev)
    for entry65 in (None, e65):
        entry = to_i32(decode_v3._compose_entry_states(root, val, entry65))
        for got, want in zip(kns.numeric_scan(*planes, entry),
                             kns.numeric_scan_plain(*planes, entry)):
            _same(got, want)


@pytest.mark.parametrize("b,nb,kind", [
    (16, 1, "random"), (16, 33, "random"), (48, 7, "random"),
    (8192, 77, "random"), (8192, 512, "random"), (33, 9, "random"),
    (8192, 77, "index")])
def test_numeric_scan_kernel_random_planes(dev, b, nb, kind):
    """Every cls value 0..7 on random slots with random r6 bits, random
    entry states; or every position an INDEX. nb = 1, 7, 9, 33 and 77
    leave part of an 8-lane block empty, b = 16 is under a window, 33 and
    48 end in a ragged window, 8192 runs 128 tiles through the ring;
    (8192, 512) is a 4 MiB streamed tile's shape."""
    make = random_planes if kind == "random" else all_index_planes
    args = [torch.from_numpy(x).to(dev) for x in make(b, nb, b + nb)]
    for got, want in zip(kns.numeric_scan(*args),
                         kns.numeric_scan_plain(*args)):
        _same(got, want)


@pytest.mark.parametrize("b,nb", [(64, 9), (8192, 77)])
def test_numeric_scan_kernel_deep_chain(dev, b, nb):
    """A first window of every lane holding a chain of DEEP INDEX steps,
    each hanging on the one before through an ADD writer: DEEP + 1
    fixpoint rounds in one window (tests/test_torch_numeric_scan_design.py
    counts them)."""
    args = [torch.from_numpy(x).to(dev)
            for x in deep_chain_planes(b, nb, 7)]
    for got, want in zip(kns.numeric_scan(*args),
                         kns.numeric_scan_plain(*args)):
        _same(got, want)


def test_numeric_scan_build_failure_raises_without_fallback(dev,
                                                            monkeypatch):
    """A kernel library that does not build makes the wrapper raise on a
    CUDA tensor; the plain twin is never taken there."""
    def no_build():
        raise RuntimeError("nvcc failed: forced")

    monkeypatch.setattr(_build, "_lib", None)
    monkeypatch.setattr(_build, "build", no_build)
    monkeypatch.setattr(kns, "numeric_scan_plain", None)  # must not be hit
    z = torch.zeros((16, 4), dtype=torch.int32, device=dev)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        kns.numeric_scan(z, z, z, torch.zeros((65, 4), dtype=torch.int32,
                                              device=dev))


def test_resolve_scan_apply_on_card(dev):
    """`_resolve(apply="scan")` (block_maps, compose, numeric_scan) equals
    the vectorized apply on the card and the CPU path."""
    img = testimages.mixed(640, 360, 4, seed=2)
    s = oracle.encode(img, fmt.StreamDesc(640, 360, 4))
    raw = np.frombuffer(s, np.uint8)[fmt.HEADER_SIZE:]
    m = decode_pipeline.bucket_size(len(raw))
    pad = np.zeros(m, np.uint8)
    pad[: len(raw)] = raw
    b = decode_v3._scan_block_len(m)
    outs = {}
    for d in (dev, torch.device("cpu")):
        f = decode_v3._fields(torch.from_numpy(pad).to(d), len(s) - 22)
        starts, cls, r6, d32, lit32, npix = f
        w0, _ = decode_v3._initial_w(cls, r6, d32, lit32, npix)
        w0 = torch.where(starts, w0, 0)
        outs[d.type] = [decode_v3._resolve(cls, r6, w0, d32, lit32, m, b,
                                           apply=a) for a in ("scan",
                                                              "vector")]
    for got in outs["cuda"] + outs["cpu"]:
        for x, y in zip(got, outs["cpu"][1]):
            assert torch.equal(x.cpu(), y)


@pytest.mark.parametrize("engine", ["v1", "v2"])
@pytest.mark.parametrize("ch", [3, 4])
def test_cross_check_decoders_on_card_match_oracle(dev, engine, ch):
    """The v1 and v2 decoders on the card: the edge-case suite and the
    adversarial stream, pixel-identical to the oracle."""
    from qoi_tpu_torch.models import decode_v2

    dec = decode_pipeline.decode if engine == "v1" else decode_v2.decode
    streams = [oracle.encode(img, fmt.StreamDesc(img.shape[1], img.shape[0],
                                                 ch))
               for img in testimages.edge_case_suite(ch).values()]
    streams.append(fmt.pack_header(fmt.StreamDesc(640, 480, 4))
                   + b"\x05" * (640 * 480) + fmt.TRAILER)
    for s in streams:
        np.testing.assert_array_equal(dec(s, 0, dev)[0], oracle.decode(s)[0])


def _random_state(seed):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(-2**31, 2**31, 65).astype(np.int32))


@pytest.mark.parametrize("case", ["mixed", "adversarial", "truncated",
                                  "noise_rgb"])
def test_decode_scan_kernel_matches_twin(dev, case):
    """4096 pixels from a random entry state (a chained tile's)."""
    if case == "adversarial":
        body = b"\x05" * 4096
    else:
        img = {"mixed": lambda: testimages.mixed(64, 64, 4),
               "truncated": lambda: testimages.photo(64, 64, 4),
               "noise_rgb": lambda: testimages.noise(64, 64, 3, seed=2)}[
                   case]()
        h, w, ch = img.shape
        body = oracle.encode(img, fmt.StreamDesc(w, h, ch))[
            fmt.HEADER_SIZE:]
        if case == "truncated":
            body = body[: len(body) // 3]
    data = torch.frombuffer(bytearray(body + fmt.TRAILER), dtype=torch.uint8)
    state = _random_state(len(body))
    got = kscan.decode_scan(data.to(dev), 4096, len(body), state.to(dev))
    want = kscan.decode_scan_plain(data, 4096, len(body), state)
    for g, w_ in zip(got, want):
        _same(g, w_)


@pytest.mark.parametrize("case", ["mixed", "flat", "noise", "runs"])
def test_encode_scan_kernel_matches_twin(dev, case):
    img = {"mixed": lambda: testimages.mixed(64, 64, 4),
           "flat": lambda: testimages.flat(64, 64, 4),
           "noise": lambda: testimages.noise(64, 64, 4, seed=3),
           "runs": lambda: testimages.runs_with_caps(256, 16, 4)}[case]()
    px32 = torch.from_numpy(np.ascontiguousarray(img).reshape(-1, 4).view(
        np.int32).reshape(-1))
    got = kscan.encode_scan(px32.to(dev))
    want = kscan.encode_scan_plain(px32)
    torch.cuda.synchronize()
    for g, w_ in zip(got, want):
        assert g.dtype == w_.dtype and torch.equal(g.cpu(), w_)


@pytest.mark.parametrize("offset", [0, 5])
@pytest.mark.parametrize("case", DECODE_CASES)
def test_decode_scan_kernel_design_cases(dev, case, offset):
    """The design tests' cases (tests/test_torch_scan_designs.py) from a
    random entry state; `offset` starts the bytes 5 past a 16-byte
    boundary, so the producer stages from the aligned base below them."""
    data, n_px, clen = decode_case(case)
    buf = torch.frombuffer(bytearray(b"\0" * offset + data),
                           dtype=torch.uint8)
    state = torch.from_numpy(random_state(n_px + offset))
    got = kscan.decode_scan(buf.to(dev)[offset:], n_px, clen, state.to(dev))
    want = kscan.decode_scan_plain(buf[offset:], n_px, clen, state)
    for g, w_ in zip(got, want):
        _same(g, w_)


def test_decode_scan_kernel_empty_stream(dev):
    state = torch.from_numpy(random_state(1))
    got = kscan.decode_scan(torch.zeros(0, dtype=torch.uint8, device=dev), 9,
                            0, state.to(dev))
    want = kscan.decode_scan_plain(torch.zeros(0, dtype=torch.uint8), 9, 0,
                                   state)
    for g, w_ in zip(got, want):
        _same(g, w_)


@pytest.mark.parametrize("case", ENCODE_CASES + ["random_3_groups"])
def test_encode_scan_kernel_design_cases(dev, case):
    """The design tests' cases, and 3 groups and 17 pixels of random
    pixels drawn from 5 colours (runs, hits and misses across groups)."""
    if case == "random_3_groups":
        rng = np.random.default_rng(8)
        colours = rng.integers(0, 2**32, 5, dtype=np.uint64)
        px = colours[rng.integers(0, 5, 3 * 1024 + 17)].astype(np.uint32)
    else:
        px = encode_case(case)
    px32 = torch.from_numpy(px.view(np.int32))
    got = kscan.encode_scan(px32.to(dev))
    want = kscan.encode_scan_plain(px32)
    torch.cuda.synchronize()
    for g, w_ in zip(got, want):
        assert g.dtype == w_.dtype and torch.equal(g.cpu(), w_)


def test_decode_scan_kernel_on_a_full_streamed_tile(dev):
    """Tile 2 of the 8K mixed stream (4 MiB of bytes) from tile 1's exit
    state: the kernel's pixels equal the source frame's and the
    fixpoint's, and its exit state the one those pixels imply."""
    from qoi_tpu_torch.models import streamed
    img = testimages.mixed(7680, 4320, 4, seed=3)
    stream = oracle.encode(img, fmt.StreamDesc(7680, 4320, 4))
    tile = 1 << 22
    data = torch.frombuffer(bytearray(stream[fmt.HEADER_SIZE:fmt.HEADER_SIZE
                                             + 2 * tile]),
                            dtype=torch.uint8).to(dev)
    clen = len(stream) - fmt.HEADER_SIZE - fmt.TRAILER_SIZE
    fix1, used1, entry = streamed._dec_tile_at(
        data, 0, clen, streamed._seed65(dev), tile, tile, 12, 1 << 30)
    fix2, used2, _ = streamed._dec_tile_at(data, used1, clen, entry, tile,
                                           tile, 12, 1 << 30)
    n1, n2 = fix1.numel(), fix2.numel()
    entry = to_i32(entry)
    px, exit65 = kscan.decode_scan(data[used1:used1 + tile], n2, used2,
                                   entry)
    src = torch.from_numpy(np.ascontiguousarray(img).reshape(-1, 4).view(
        np.int32).reshape(-1)[n1:n1 + n2].copy())
    _same(px, src)
    _same(px, fix2)
    _same(exit65, kscan.exit_state_of(px, entry))


def test_scan_codec_encode_4k_matches_oracle(dev):
    img = testimages.mixed(3840, 2160, 4, seed=3)
    desc = fmt.StreamDesc(3840, 2160, 4)
    want = oracle.encode(img, desc)
    assert scan_codec.encode(img, desc, dev) == want
    np.testing.assert_array_equal(scan_codec.decode(want, 0, dev)[0], img)


@pytest.mark.parametrize("ch", [3, 4])
def test_scan_codec_on_card_matches_oracle(dev, ch):
    for name, img in testimages.edge_case_suite(ch).items():
        h, w = img.shape[:2]
        desc = fmt.StreamDesc(w, h, ch)
        want = oracle.encode(img, desc)
        assert scan_codec.encode(img, desc, dev) == want, name
        got, _ = scan_codec.decode(want, 0, dev)
        np.testing.assert_array_equal(got, img, name)


def _slide2_events(nseg, sw, p, seed):
    """Two random value planes and aux = alive | (index - rank) << 1."""
    rng = np.random.default_rng(seed)
    alive = rng.random((nseg, sw)) < p
    rank = np.cumsum(alive, axis=1) - alive
    d = np.where(alive, np.arange(sw)[None, :] - rank, 0)
    aux = (alive | d << 1).astype(np.int32)
    v1, v2 = (rng.integers(-2**31, 2**31, (nseg, sw)).astype(np.int32)
              for _ in range(2))
    return tuple(torch.from_numpy(x) for x in (v1, v2, aux))


@pytest.mark.parametrize("nseg,sw,p", [
    (37, 4096, 0.45), (3, 4096, 1.0), (5, 512, 0.0), (1, 64, 0.3)])
def test_slide_val2_kernel_matches_twin(dev, nseg, sw, p):
    planes = [t.to(dev) for t in _slide2_events(nseg, sw, p, nseg)]
    for got, want in zip(kslide.slide_val2(*planes),
                         kslide.slide_val2_plain(*planes)):
        _same(got, want)


@pytest.mark.parametrize("case", ["mixed", "photo"])
def test_dense_decode_on_card_matches_cpu_and_source(dev, case):
    img = (testimages.mixed(160, 120, 4) if case == "mixed"
           else testimages.photo(160, 120, 4))
    s = oracle.encode(img, fmt.StreamDesc(160, 120, 4))
    raw = np.frombuffer(s, np.uint8)[fmt.HEADER_SIZE:]
    pad = np.zeros(max(decode_pipeline.bucket_size(len(raw)), 4096), np.uint8)
    pad[: len(raw)] = raw
    npc = decode_pipeline.bucket_size(160 * 120)
    cpu, _, _ = decode_v3._decode_device(torch.from_numpy(pad), len(s) - 22,
                                         npc, dense=True)
    gpu, conv, _ = decode_v3._decode_device(torch.from_numpy(pad).to(dev),
                                            len(s) - 22, npc, dense=True)
    assert conv
    _same(gpu, cpu)
    px = decode_v3.unpack_px32(gpu.cpu().numpy())[: 160 * 120]
    np.testing.assert_array_equal(px.reshape(120, 160, 4), img)


def _staging(n, kind, seed):
    rng = np.random.default_rng(seed)
    lens = {"mixed": lambda: rng.integers(0, 7, n),
            "six_spill": lambda: np.r_[3, np.full(n - 1, 6)],
            "sparse": lambda: np.where(rng.random(n) < 0.01,
                                       rng.integers(1, 7, n), 0),
            "empty": lambda: np.zeros(n, np.int64)}[kind]()
    st = rng.integers(0, 256, (6, n), dtype=np.uint8)
    st = np.where(np.arange(6)[:, None] < lens[None, :], st, 0)
    return (torch.from_numpy(st.astype(np.uint8)),
            torch.from_numpy(lens.astype(np.int32)))


@pytest.mark.parametrize("n,kind", [
    (4096 * 9, "mixed"), (4096 * 2, "six_spill"), (4096 * 4, "sparse"),
    (4096, "empty"), (1024, "mixed")])
def test_place_words_kernel_matches_twin(dev, n, kind):
    st, lens = (t.to(dev) for t in _staging(n, kind, n))
    off_d, lo_d, hi_d, total = kpack.densify_records(st, lens)
    wp, c0, c1 = kpack._prep_planes(off_d, lo_d, hi_d, total)
    planes = (wp.to(torch.int32), to_i32(c0), to_i32(c1))
    for w_cap in (n * 6 // 4, int(total) // 4 + 1):   # full and truncated
        _same(kpack.place_words(*planes, w_cap),
              kpack.place_words_plain(*planes, w_cap))


def _slide_events(nseg, sw, p, seed):
    """One random value plane and aux = alive | (index - rank) << 1: the
    events land densely at [0, count) of each row."""
    v, _, aux = _slide2_events(nseg, sw, p, seed)
    return v, aux


@pytest.mark.parametrize("nseg,sw,p", [
    (3, 16, 0.5),            # one block (k = 1)
    (4, 4098, 0.4),          # k = 2, sw not a multiple of 4: word stores
    (5, 20002, 0.3),         # k = 8, slices of 2501 words, the last 2495
    (6, 32780, 0.5),         # k = 8, slices of 4100 words, the last 4080
    (7, 40960, 0.35),        # the 4K shape's row
    (2, kslide.MAX_SW, 0.6),  # the widest row accepted: 8 x 12288 words
    (2, kslide.MAX_SW, 1.0)])
def test_slide_val_cluster_rows(dev, nseg, sw, p):
    """The cluster slide at rows k does not divide, both store widths and
    the widest row."""
    k, width = kslide.cluster_shape(sw)
    assert k * width >= sw and width <= kslide.MAX_SLICE
    val, aux = (t.to(dev) for t in _slide_events(nseg, sw, p, sw))
    _same(kslide.slide_val(val, aux), kslide.slide_val_plain(val, aux))


def test_slide_val_refuses_rows_past_the_limit(dev):
    z = torch.zeros((1, kslide.MAX_SW + 1), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match=str(kslide.MAX_SW)):
        kslide.slide_val(z, z)


@pytest.mark.parametrize("n,kind", [(4096 * 9, "mixed"), (8192, "six_spill")])
def test_compact_bytes6_pack_on_card_matches_cpu(dev, n, kind):
    st, lens = _staging(n, kind, 3 * n)
    bc, tc = kpack.compact_bytes6_pack(st, lens, n * 6)
    bg, tg = kpack.compact_bytes6_pack(st.to(dev), lens.to(dev), n * 6)
    assert int(tg) == int(tc)
    assert torch.equal(bg.cpu(), bc)


def _px4(img, cap):
    h, w, ch = img.shape
    px4 = pipeline.force_rgba(img, fmt.StreamDesc(w, h, ch))
    out = np.zeros((cap, 4), np.uint8)
    out[: px4.shape[0]] = px4
    return torch.from_numpy(out), px4.shape[0]


@pytest.mark.parametrize("case,last_pos", [
    ("mixed", None), ("flat", None), ("flat", -1), ("flat", 5000),
    ("palette", None), ("noise_ragged", None), ("runs_rgb", None),
    ("big_mixed", None)])
def test_encode_stage_kernel_matches_twin(dev, case, last_pos):
    """Staging and lengths, zeroed bytes included. big_mixed has 1100
    blocks, so the carry scan runs over more than one 1024-entry chunk."""
    img, cap = {
        "mixed": (testimages.mixed(200, 120, 4), 24576),
        "flat": (testimages.flat(300, 40, 4), 12288),
        "palette": (testimages.palette(300, 40, 4, colors=9, seed=5), 12288),
        "noise_ragged": (testimages.noise(97, 51, 4, seed=8), 6144),
        "runs_rgb": (testimages.runs_with_caps(130, 40, 3), 6144),
        "big_mixed": (testimages.mixed(1100, 1024, 4), 1100 * 1024),
    }[case]
    px4, n = _px4(img, cap)
    px4 = px4.to(dev)
    got = kstage.encode_stage_pallas(px4, n, last_pos=last_pos)
    want = kstage.encode_stage_plain(px4, n, last_pos)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(g.cpu(), w.cpu())


def _stage_same(px4, n, last_pos=None):
    got = kstage.encode_stage_pallas(px4, n, last_pos=last_pos)
    want = kstage.encode_stage_plain(px4, n, last_pos)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(g.cpu(), w.cpu())


@pytest.mark.parametrize("case", ["mixed", "flat", "short"])
def test_encode_stage_one_block(dev, case):
    """N = 1024: block 0 alone, no look-back."""
    img = {"mixed": testimages.mixed(32, 32, 4),
           "flat": testimages.flat(32, 32, 4),
           "short": testimages.noise(30, 21, 4, seed=2)}[case]
    px4, n = _px4(img, 1024)
    _stage_same(px4.to(dev), n)


@pytest.mark.parametrize("last_pos", [None, -1])
def test_encode_stage_one_colour_4k(dev, last_pos):
    """A one-colour 4K frame: after pixel 0 no pixel is a literal, so 63
    slots and the literal column are never written again and every
    block's look-back runs to a final word far back."""
    px4, n = _px4(testimages.flat(3840, 2160, 4), 1 << 23)
    _stage_same(px4.to(dev), n, last_pos)


def test_encode_stage_back_to_back(dev):
    """Calls queued back to back on one stream, at two sizes and with the
    run cut moved, each get fresh look-back words and stay exact."""
    a, n_a = _px4(testimages.palette(300, 40, 4, colors=9, seed=5), 12288)
    b, n_b = _px4(testimages.mixed(200, 120, 4), 24576)
    a, b = a.to(dev), b.to(dev)
    calls = [(a, n_a, None), (a[:8192], 8000, None), (a, n_a, 5000),
             (b, n_b, None), (a, n_a, None)]
    got = [kstage.encode_stage_pallas(px, n, last_pos=lp)
           for px, n, lp in calls]
    for (px, n, lp), g in zip(calls, got):
        want = kstage.encode_stage_plain(px, n, lp)
        torch.cuda.synchronize()
        for gg, w in zip(g, want):
            assert torch.equal(gg.cpu(), w.cpu())


@pytest.mark.parametrize("ch", [3, 4])
def test_pack_encode_on_card_matches_oracle(dev, ch):
    """encode_device_pack, and the fused staging packed by
    compact_bytes6_pack, equal the oracle's bytes on every edge case."""
    for name, img in testimages.edge_case_suite(ch).items():
        h, w = img.shape[:2]
        desc = fmt.StreamDesc(w, h, ch)
        want = oracle.encode(img, desc)
        px4, n = _px4(img, 4096)
        px4 = px4.to(dev)
        stag, lens = kstage.encode_stage_pallas(px4, n)
        for buf, tot in (pipeline.encode_device_pack(px4, n),
                         kpack.compact_bytes6_pack(stag.T.contiguous(),
                                                   lens[:, 0], 4096 * 6)):
            got = (fmt.pack_header(desc)
                   + buf[: int(tot)].cpu().numpy().tobytes() + fmt.TRAILER)
            assert got == want, name


# ---- encode_stage_words: the encode main path's staging -----------------

def _words_same(got, want):
    torch.cuda.synchronize()
    for g, w in zip((got.lo, got.hi, got.lens, *got.carry),
                    (want.lo, want.hi, want.lens, *want.carry)):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(g.cpu(), w.cpu())


def _on(dev, x):
    if isinstance(x, tuple):
        return tuple(_on(dev, y) for y in x)
    return x.to(dev) if isinstance(x, torch.Tensor) else x


def _words_case(dev, px4, n_valid=None, **kw):
    """The kernel with the carry as given (host tensors are copied to
    the card by its wrapper), against the twin with it on the card."""
    got = kstage.encode_stage_words(px4, n_valid, **kw)
    _words_same(got, kstage.encode_stage_words_plain(
        px4, _on(dev, n_valid), **{k: _on(dev, v) for k, v in kw.items()}))
    return got


@pytest.fixture(scope="module")
def frames_4k():
    """(N, 4) uint8 of three 4K frames padded to the facade's bucket,
    and the pixel count: RGBA mixed, RGB photo, one colour."""
    n = 3840 * 2160
    return {k: _px4(img, decode_pipeline.bucket_size(n))[0]
            for k, img in (("mixed", testimages.mixed(3840, 2160, 4, seed=3)),
                           ("photo_rgb", testimages.photo(3840, 2160, 3,
                                                          seed=3)),
                           ("one_colour", testimages.flat(3840, 2160, 4)))}, n


@pytest.mark.parametrize("kind", ["mixed", "photo_rgb", "one_colour"])
def test_encode_stage_words_matches_twin_4k(dev, frames_4k, kind):
    """The main path's shape: a 4K frame in its 2^23-pixel bucket, the
    seed carry in, the carry out (contains_last not given)."""
    frames, n = frames_4k
    _words_case(dev, frames[kind].to(dev), n)


@pytest.mark.parametrize("n,n_valid", [(256, 256), (1000, 1000),
                                       (1024, 1024), (1025, 1025),
                                       (1025, 700), (4097, 4000),
                                       (1100 * 1024 + 3, 1100 * 1024)])
def test_encode_stage_words_ragged(dev, n, n_valid):
    """Any N: one block, a ragged last block, n_valid below N; 1101
    blocks, whose look-back walks far."""
    img = testimages.mixed(1100, 1025, 4, seed=n % 7)
    px4, _ = _px4(img, 1100 * 1025)
    _words_case(dev, px4[:n].to(dev), n_valid)


@pytest.mark.parametrize("run_in", [0, 1, 61])
@pytest.mark.parametrize("last", [False, True, None])
def test_encode_stage_words_carries(dev, run_in, last):
    """A carry in with a table whose unwritten entries are garbage, as
    Python values and as tensors on the card, and the carry out."""
    rng = np.random.default_rng(run_in)
    tbl = torch.from_numpy(rng.integers(0, 1 << 32, 64, dtype=np.int64))
    wr = torch.from_numpy(rng.random(64) < 0.5)
    img = testimages.mixed(130, 100, 4, seed=run_in)
    px4, n = _px4(img, 16384)
    px4[:300] = torch.tensor([12, 200, 7, 255], dtype=torch.uint8)
    px4[:40] = 0
    px4 = px4.to(dev)
    prev = torch.tensor([12, 200, 7, 255], dtype=torch.uint8)
    for on_card in (False, True):
        to = (lambda x: x.to(dev)) if on_card else (lambda x: x)
        kw = dict(prev_in=to(prev), table_in=(to(tbl), to(wr)),
                  run_in=torch.tensor(run_in, device=dev) if on_card
                  else run_in,
                  contains_last=last)
        _words_case(dev, px4, n, **kw)
        _words_case(dev, px4, torch.tensor(n - 77, device=dev), **kw)
    _words_case(dev, px4, None, contains_last=last)


#: the words and planes kernels' 4096-pixel tile: N one short, whole, one
#: over, three tiles and a ragged fourth
TILE_EDGES = [4095, 4096, 4097, 3 * 4096 + 1000]


def _tile_edge_inputs(n):
    """(N, 4) pixels of a mixed frame with a run across the first tile's
    end and one colour at positions 10 and 1287 (warps 0 and 10 of tile
    0); a carry in with a pending run, prev_in and a table whose
    unwritten entries are garbage."""
    img = testimages.mixed(128, 110, 4, seed=n % 11)
    px4, _ = _px4(img, 128 * 110)
    px4 = px4[:n].clone()
    px4[4000:4200] = px4[4000]
    px4[[10, 1287]] = torch.tensor([1, 2, 3, 255], dtype=torch.uint8)
    rng = np.random.default_rng(n)
    tbl = torch.from_numpy(rng.integers(0, 1 << 32, 64, dtype=np.int64))
    wr = torch.from_numpy(rng.random(64) < 0.5)
    return px4, dict(prev_in=px4[5].clone(), run_in=23,
                     table_in=(tbl, wr))


@pytest.mark.parametrize("n", TILE_EDGES)
@pytest.mark.parametrize("last", [False, None])
def test_encode_stage_words_tile_edges(dev, n, last):
    """At the tile's edges, with carries in (as values and as card
    tensors) and the carry out; n_valid N and N - 77."""
    px4, kw = _tile_edge_inputs(n)
    px4 = px4.to(dev)
    for on_card in (False, True):
        k = {key: _on(dev, v) if on_card else v for key, v in kw.items()}
        if on_card:
            k["run_in"] = torch.tensor(kw["run_in"], device=dev)
        for nv in (n, n - 77):
            _words_case(dev, px4, nv, contains_last=last, **k)
    _words_case(dev, px4, None, contains_last=last)


def test_encode_stage_words_offset_view(dev):
    """An input view 4 bytes off its buffer's start."""
    px4, n = _px4(testimages.mixed(200, 120, 4, seed=2), 24577)
    view = px4.to(dev)[1:]
    assert view.data_ptr() % 16 == 4
    _words_case(dev, view, n - 1, run_in=5, contains_last=False)


def test_encode_stage_words_back_to_back_4k(dev, frames_4k):
    """100 launches queued back to back at 4K, each bit-equal to the
    first and the first to the twin: a race in the look-back would show
    as a launch that differs."""
    frames, n = frames_4k
    px4 = frames["mixed"].to(dev)
    first = _words_case(dev, px4, n, contains_last=False)
    runs = [kstage.encode_stage_words(px4, n, contains_last=False)
            for _ in range(100)]
    torch.cuda.synchronize()
    want = (first.lo, first.hi, first.lens, *first.carry)
    for got in runs:
        assert all(torch.equal(g, w) for g, w in
                   zip((got.lo, got.hi, got.lens, *got.carry), want))


def test_main_path_encodes_through_the_words_kernel(dev):
    """The facade at 4K and the streamed 8K encode: the oracle's bytes,
    one staging launch a frame or tile and no plain staging."""
    for w, h in ((3840, 2160), (7680, 4320)):
        img = testimages.mixed(w, h, 4, seed=5)
        want = oracle.encode(img, fmt.StreamDesc(w, h, 4))
        _build.reset_launches()
        assert qoi_tpu_torch.encode(img, device=dev) == want
        assert _build.launches["encode_stage_words"] == (
            1 if w * h <= qoi_tpu_torch.STREAM_THRESHOLD_PX
            else -(-w * h // (1 << 22)))


def test_encode_tiled_launches_the_words_kernel(dev):
    """encode_tiled over S = 4 gloo ranks sharing the card: the oracle's
    bytes on every rank, each rank's phase B one staging launch."""
    from qoi_tpu_torch.parallel.launch import RankPool

    import torch_parallel_tasks as tasks

    img = testimages.mixed(1920, 1080, 4, seed=3)
    stream = oracle.encode(img, fmt.StreamDesc(1920, 1080, 4))
    _build.build()
    with RankPool(4, device="cuda", timeout_s=600) as pool:
        res = pool.run(tasks.roundtrip_on_card, img, stream)
    for r, (same_stream, same_px, conv, launches, _) in enumerate(res):
        assert same_stream and same_px and conv, f"rank {r}"
        assert launches["encode_stage_words"] == 1, f"rank {r}: {launches}"


# ---- encode_stage_planes: the pack encode's byte-plane staging ----------

def _planes_case(dev, px4, n_valid=None, **kw):
    """The planes kernel with the carry as given, against its twin with
    the carry on the card: planes, lens and every carry field."""
    got = kstage.encode_stage_planes(px4, n_valid, **kw)
    want = kstage.encode_stage_planes_plain(
        px4, _on(dev, n_valid), **{k: _on(dev, v) for k, v in kw.items()})
    torch.cuda.synchronize()
    for g, w in zip((got.staging, got.lens, *got.carry),
                    (want.staging, want.lens, *want.carry)):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(g.cpu(), w.cpu())
    return got


@pytest.mark.parametrize("kind", ["mixed", "photo_rgb", "one_colour"])
def test_encode_stage_planes_matches_twin_4k(dev, frames_4k, kind):
    """The pack encode's shape: a 4K frame in its 2^23-pixel bucket, the
    seed carry in, the carry out."""
    frames, n = frames_4k
    _planes_case(dev, frames[kind].to(dev), n)


@pytest.mark.parametrize("n,n_valid", [(1, 1), (1000, 1000), (1024, 1024),
                                       (1025, 1025), (1025, 700),
                                       (4097, 4000), (4100, 4100),
                                       (1100 * 1024 + 3, 1100 * 1024)])
def test_encode_stage_planes_ragged(dev, n, n_valid):
    """Any N: one block, a ragged last block and plane rows off 16 bytes
    (byte stores), n_valid below N (padding keeps its run byte), 1101
    blocks."""
    img = testimages.mixed(1100, 1025, 4, seed=n % 7)
    px4, _ = _px4(img, 1100 * 1025)
    _planes_case(dev, px4[:n].to(dev), n_valid)


@pytest.mark.parametrize("run_in", [0, 1, 61])
@pytest.mark.parametrize("last", [False, True, None])
def test_encode_stage_planes_carries(dev, run_in, last):
    """Carries in as Python values and as tensors on the card, with a
    table whose unwritten entries are garbage, and the carry out."""
    rng = np.random.default_rng(run_in + 3)
    tbl = torch.from_numpy(rng.integers(0, 1 << 32, 64, dtype=np.int64))
    wr = torch.from_numpy(rng.random(64) < 0.5)
    px4, n = _px4(testimages.mixed(130, 100, 4, seed=run_in), 16384)
    px4[:300] = torch.tensor([12, 200, 7, 255], dtype=torch.uint8)
    px4[:40] = 0
    px4 = px4.to(dev)
    prev = torch.tensor([12, 200, 7, 255], dtype=torch.uint8)
    for on_card in (False, True):
        to = (lambda x: x.to(dev)) if on_card else (lambda x: x)
        kw = dict(prev_in=to(prev), table_in=(to(tbl), to(wr)),
                  run_in=torch.tensor(run_in, device=dev) if on_card
                  else run_in,
                  contains_last=last)
        _planes_case(dev, px4, n, **kw)
        _planes_case(dev, px4, torch.tensor(n - 77, device=dev), **kw)
    _planes_case(dev, px4, None, contains_last=last)


@pytest.mark.parametrize("n", TILE_EDGES)
@pytest.mark.parametrize("last", [True, None])
def test_encode_stage_planes_tile_edges(dev, n, last):
    """The planes kernel at the tile's edges (4-byte plane stores where N
    is a multiple of 4, byte stores otherwise), carries in as values and
    as card tensors, the carry out."""
    px4, kw = _tile_edge_inputs(n)
    px4 = px4.to(dev)
    for on_card in (False, True):
        k = {key: _on(dev, v) if on_card else v for key, v in kw.items()}
        for nv in (n, n - 77):
            _planes_case(dev, px4, nv, contains_last=last, **k)
    _planes_case(dev, px4, None, contains_last=last)


def test_encode_stage_planes_offset_view(dev):
    """An input view 4 bytes off its buffer's start."""
    px4, n = _px4(testimages.mixed(200, 120, 4, seed=2), 24577)
    view = px4.to(dev)[1:]
    assert view.data_ptr() % 16 == 4
    _planes_case(dev, view, n - 1, run_in=5, contains_last=False)


def test_pack_encode_launches_the_planes_kernel(dev, frames_4k,
                                                monkeypatch):
    """encode_device_pack at 4K: the oracle's bytes, one planes launch a
    frame and no plain staging; 100 launches back to back, each equal to
    the first."""
    frames, n = frames_4k
    img = testimages.mixed(3840, 2160, 4, seed=3)
    want = oracle.encode(img, fmt.StreamDesc(3840, 2160, 4))
    px4 = frames["mixed"].to(dev)
    first = _planes_case(dev, px4, n)

    def no_plain(*a, **k):
        raise AssertionError("plain staging on the card")

    monkeypatch.setattr(pipeline, "stage_chunks_plain", no_plain)
    _build.reset_launches()
    buf, tot = pipeline.encode_device_pack(px4, n)
    got = (fmt.pack_header(fmt.StreamDesc(3840, 2160, 4))
           + buf[: int(tot)].cpu().numpy().tobytes() + fmt.TRAILER)
    assert got == want
    assert _build.launches["encode_stage_planes"] == 1
    runs = [kstage.encode_stage_planes(px4, n) for _ in range(100)]
    torch.cuda.synchronize()
    for r in runs:
        assert torch.equal(r.staging, first.staging)
        assert torch.equal(r.lens, first.lens)


def test_wrappers_count_launches(dev):
    _build.reset_launches()
    z = torch.zeros((2, 8), dtype=torch.int32, device=dev)
    kslide.slide_val(z, z)
    kcw.compact_words(z[0], z[0], z[0], 48)
    kexp.expand_px(z[0], z[0], 4)
    kbm.block_maps(z, z, z)
    kslide.slide_val2(z, z, z)
    kpack.place_words(z[0], z[0], z[0], 4)
    kstage.encode_stage_pallas(
        torch.zeros((1024, 4), dtype=torch.uint8, device=dev), 7)
    kstage.encode_stage_words(
        torch.zeros((300, 4), dtype=torch.uint8, device=dev), 7)
    kstage.encode_stage_planes(
        torch.zeros((300, 4), dtype=torch.uint8, device=dev), 7)
    kscan.encode_scan(z[0])
    kscan.decode_scan(z[0].view(torch.uint8), 4, 4,
                      torch.zeros(65, dtype=torch.int32, device=dev))
    kns.numeric_scan(z, z, z, torch.zeros((65, 8), dtype=torch.int32,
                                          device=dev))
    kbs.fsm_scan(z[0].view(torch.uint8))
    kbs.fsm_starts(z[0].view(torch.uint8), 5)
    kbs.initial_scan(z[0], z[1])
    kbs.initial_w_scan(z[0].view(torch.uint8),
                       z[1].view(torch.uint8) != 0)
    kbs.anch_scan(z)
    z4 = torch.zeros((4, 8), dtype=torch.uint8, device=dev)
    kbs.resolve_scan(z4, z4)
    torch.cuda.synchronize()
    assert _build.launches == {"slide_val": 1, "expand_px": 1,
                               "block_maps": 1, "slide_val2": 1,
                               "place_words": 1, "encode_stage": 1,
                               "encode_stage_words": 1,
                               "encode_stage_planes": 1,
                               "encode_scan": 1, "decode_scan": 1,
                               "numeric_scan": 1, "fsm_scan": 1,
                               "fsm_starts": 1, "initial_scan": 1,
                               "initial_w_scan": 1, "anch_scan": 1,
                               "resolve_scan": 1, "compact_words": 1}


# ---- blocked_scan: the decode's three one-pass scans ---------------------

#: ragged lengths around the kernel's tiles (8192 bytes, 4096 leaves) and
#: rows of 513 and 1026 tiles, whose look-back windows slide past 32 tiles
SCAN_LENGTHS = [1, 2, 31, 4095, 4096, 4097, 8191, 8192, 8193, 70001,
                4096 * 1025 + 3]


def _same_scan(got, want):
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(g.cpu(), w.cpu())


@pytest.mark.parametrize("n", SCAN_LENGTHS)
def test_fsm_scan_kernel_matches_twin(dev, n):
    rng = np.random.default_rng(n)
    data = torch.from_numpy(rng.integers(0, 256, n + 1).astype(np.uint8))
    data = data.to(dev)
    for x in (data[:n], data[1:]):     # the second starts off alignment
        _same_scan((kbs.fsm_scan(x),), (kbs.fsm_scan_plain(x),))


@pytest.mark.parametrize("n", SCAN_LENGTHS)
@pytest.mark.parametrize("bits", ["fields", "any"])
def test_initial_scan_kernel_matches_twin(dev, n, bits):
    """Random bits in every field of the 22-bit leaf and npix in [0, 63),
    or any 32-bit leaf and any int32 npix: the kernel and the twin agree
    on every bit pattern."""
    rng = np.random.default_rng(n + 7)
    hi = 1 << 22 if bits == "fields" else 1 << 32
    leaf = to_i32(torch.from_numpy(rng.integers(0, hi, n + 1,
                                                dtype=np.int64))).to(dev)
    npix = (rng.integers(0, 63, n + 1) if bits == "fields" else
            rng.integers(-(1 << 31), 1 << 31, n + 1))
    npix = torch.from_numpy(npix.astype(np.int32)).to(dev)
    for a, b in ((leaf[:n], npix[:n]), (leaf[1:], npix[1:])):
        _same_scan(kbs.initial_scan(a, b), kbs.initial_scan_plain(a, b))


def _stream_like_bytes(n, seed):
    """n bytes of a stream's op mix (RGB and RGBA literals, INDEX, DIFF,
    LUMA and runs in every position), so that random starts land on every
    class."""
    rng = np.random.default_rng(seed)
    b = rng.integers(0, 256, n + 5)
    b[rng.random(n + 5) < 0.1] = 0xFE
    b[rng.random(n + 5) < 0.05] = 0xFF
    return torch.from_numpy(b.astype(np.uint8))


@pytest.mark.parametrize("n", SCAN_LENGTHS)
def test_fsm_starts_kernel_matches_twin(dev, n):
    """The starts form against its twin: aligned and one byte off, with
    chunks_len past, at and inside the bytes."""
    data = _stream_like_bytes(n, n).to(dev)
    for x in (data[:n], data[1:n + 1], data[3:n + 3]):
        for clen in (n + 8, n, n // 2):
            _same_scan(kbs.fsm_starts(x, clen), kbs.fsm_starts_plain(x, clen))


@pytest.mark.parametrize("n", SCAN_LENGTHS)
@pytest.mark.parametrize("entry", ["seed", "px"])
def test_initial_w_scan_kernel_matches_twin(dev, n, entry):
    """The bytes form against its twin: the FSM's own starts and random
    ones (every op class at every position), bytes and starts each
    aligned or one off, the seed or a random entry px."""
    rng = np.random.default_rng(n + 11)
    data = _stream_like_bytes(n, n + 1).to(dev)
    e = (None if entry == "seed" else
         torch.tensor(int(rng.integers(0, 1 << 32)), device=dev))
    rnd = torch.from_numpy(rng.random(n + 1) < 0.5).to(dev)
    for x in (data[:n], data[1:n + 1]):
        for st in (kbs.fsm_starts(x, n)[0], rnd[:n], rnd[1:]):
            _same_scan(kbs.initial_w_scan(x, st, e),
                       kbs.initial_w_scan_plain(x, st, e))


@pytest.mark.parametrize("rows,length", [
    (1, n) for n in SCAN_LENGTHS] + [(64, 16), (64, 8192), (3, 4097),
                                     (5, 4096 * 3), (64, 1)])
def test_anch_scan_kernel_matches_twin(dev, rows, length):
    rng = np.random.default_rng(rows * length)
    for hi in (128, 1 << 32):
        leaf = to_i32(torch.from_numpy(rng.integers(
            0, hi, (rows, length), dtype=np.int64))).to(dev)
        _same_scan((kbs.anch_scan(leaf),), (kbs.anch_scan_plain(leaf),))


def test_blocked_scans_at_a_4k_stream(dev):
    """The three scans at a 4K mixed stream's path shapes: its padded
    bytes, `_initial_w`'s leaf and npix, `_anchored_w`'s leaf from the
    round-1 px, and the surgical round's (64, b) rows of it."""
    s = oracle.encode(testimages.mixed(3840, 2160, 4, seed=3),
                      fmt.StreamDesc(3840, 2160, 4))
    raw = np.frombuffer(s, np.uint8)[fmt.HEADER_SIZE:]
    pad = np.zeros(decode_pipeline.bucket_size_fine(len(raw)), np.uint8)
    pad[: len(raw)] = raw
    data, clen = torch.from_numpy(pad).to(dev), len(s) - 22
    _same_scan((kbs.fsm_scan(data),), (kbs.fsm_scan_plain(data),))
    _same_scan(kbs.fsm_starts(data, clen), kbs.fsm_starts_plain(data, clen))
    starts, cls, r6, d32, lit32, npix = decode_v3._fields(data, clen)
    leaf = decode_v3._initial_leaf(cls, r6, d32, lit32).to(torch.int32)
    npix32 = npix.to(torch.int32)
    _same_scan(kbs.initial_scan(leaf, npix32),
               kbs.initial_scan_plain(leaf, npix32))
    _same_scan(kbs.initial_w_scan(data, starts),
               kbs.initial_w_scan_plain(data, starts))
    _same_scan(kbs.initial_w_scan(data, starts),
               decode_v3._initial_w(cls, r6, d32, lit32, npix))
    px, *_ = decode_v3._decode_core(data, clen, max_rounds=1)
    a = decode_v3._anch_leaf(cls, r6, d32, px).to(torch.int32)
    _same_scan((kbs.anch_scan(a[None]),), (kbs.anch_scan_plain(a[None]),))
    b = decode_v3._scan_block_len(data.shape[0])
    rows = a.reshape(-1, b)[:64].contiguous()
    _same_scan((kbs.anch_scan(rows),), (kbs.anch_scan_plain(rows),))


def test_look_back_stress_at_a_4k_stream(dev):
    """100 back-to-back launches of each scan at the 4K mixed stream's
    shapes, each bit-equal to the first and the first to the twin: a race
    in the look-back would show as a launch that differs."""
    s = oracle.encode(testimages.mixed(3840, 2160, 4, seed=3),
                      fmt.StreamDesc(3840, 2160, 4))
    raw = np.frombuffer(s, np.uint8)[fmt.HEADER_SIZE:]
    pad = np.zeros(decode_pipeline.bucket_size_fine(len(raw)), np.uint8)
    pad[: len(raw)] = raw
    data, clen = torch.from_numpy(pad).to(dev), len(s) - 22
    starts, cls, r6, d32, lit32, npix = decode_v3._fields(data, clen)
    leaf = decode_v3._initial_leaf(cls, r6, d32, lit32).to(torch.int32)
    npix32 = npix.to(torch.int32)
    a = (npix32 * 5 + leaf) & 127
    cases = [
        (lambda: (kbs.fsm_scan(data),), lambda: (kbs.fsm_scan_plain(data),)),
        (lambda: kbs.fsm_starts(data, clen),
         lambda: kbs.fsm_starts_plain(data, clen)),
        (lambda: kbs.initial_scan(leaf, npix32),
         lambda: kbs.initial_scan_plain(leaf, npix32)),
        (lambda: kbs.initial_w_scan(data, starts),
         lambda: kbs.initial_w_scan_plain(data, starts)),
        (lambda: (kbs.anch_scan(a[None]),),
         lambda: (kbs.anch_scan_plain(a[None]),))]
    for kern, plain in cases:
        first = kern()
        _same_scan(first, plain())
        runs = [kern() for _ in range(100)]
        torch.cuda.synchronize()
        for got in runs:
            assert all(torch.equal(g, f) for g, f in zip(got, first))


def test_decode_device_launches_each_scan(dev):
    """A 4K mixed stream's decode takes two rounds: `_decode_device` runs
    the starts and the bytes-form initial scan once each (neither maps
    form) and the anchored scan in round 2, over the surgical round's
    rows or, with surgical=False, the stream."""
    s = oracle.encode(testimages.mixed(3840, 2160, 4, seed=3),
                      fmt.StreamDesc(3840, 2160, 4))
    raw = np.frombuffer(s, np.uint8)[fmt.HEADER_SIZE:]
    pad = np.zeros(decode_pipeline.bucket_size_fine(len(raw)), np.uint8)
    pad[: len(raw)] = raw
    data = torch.from_numpy(pad).to(dev)
    npc = decode_pipeline.bucket_size(3840 * 2160)
    for surgical in (True, False):
        _build.reset_launches()
        out, conv, rounds = decode_v3._decode_device(data, len(s) - 22, npc,
                                                     surgical=surgical)
        torch.cuda.synchronize()
        assert conv and rounds >= 2
        assert _build.launches["fsm_starts"] == 1
        assert _build.launches["initial_w_scan"] == 1
        assert _build.launches["fsm_scan"] == 0
        assert _build.launches["initial_scan"] == 0
        assert _build.launches["anch_scan"] >= 1


# ---- resolve_scan: v2's reset-or-add scan ------------------------------

#: lengths around the kernel's tiles (kbs.TILE_RESOLVE = 8192 positions,
#: two lanes of 4096 a thread): the lanes' edges, t - 1, t, t + 1, two
#: tiles' edges, and 1101 tiles + 5, whose look-backs slide past 32 tiles
RESOLVE_LENGTHS = [1, 17, 4095, 4096, 4097, 8191, 8192, 8193, 16383,
                   16385, 70001, 8192 * 1101 + 5]


def _resolve_leaves(m, seed, offset=0, dev=None, kind="sparse"):
    """(4, M) uint8 rflag and val, each a contiguous view `offset` bytes
    into its buffer; values of any byte (adds that wrap mod 256). Flags:
    "sparse" resets of RGB only, alpha only and both; "all" and "none";
    "odd" flag bytes of 1, 2, 0x80 and 0xFF among zeros (any nonzero byte
    resets)."""
    rng = np.random.default_rng(seed)
    if kind == "sparse":
        rgb = rng.random(m) < 0.02
        alpha = rng.random(m) < 0.01
        f = np.stack([rgb, rgb, rgb, alpha]).astype(np.uint8)
    elif kind == "odd":
        f = rng.choice(np.array([0] * 12 + [1, 2, 0x80, 0xFF], np.uint8),
                       (4, m))
    else:
        f = np.full((4, m), int(kind == "all"), np.uint8)
    v = rng.integers(0, 256, (4, m), dtype=np.uint8)
    out = []
    for x in (f, v):
        buf = torch.zeros(4 * m + offset, dtype=torch.uint8, device=dev)
        buf[offset:] = torch.from_numpy(x.reshape(-1)).to(dev)
        out.append(buf[offset:].view(4, m))
    return out


@pytest.mark.parametrize("m", RESOLVE_LENGTHS)
def test_resolve_scan_kernel_matches_twin(dev, m):
    for offset in (0, 5):
        rflag, val = _resolve_leaves(m, m + offset, offset, dev)
        _same_scan((kbs.resolve_scan(rflag, val),),
                   (kbs.resolve_scan_plain(rflag, val),))


#: M % 16 != 0 at offset 0 (rows 1-3 start off 16 bytes: the general
#: path on whole tiles), and 16-byte rows whose last tile is ragged
@pytest.mark.parametrize("m", [3 * 4096 + 8, 5 * 4096 + 4, 7 * 4096 + 16])
@pytest.mark.parametrize("kind", ["sparse", "all", "none", "odd"])
def test_resolve_scan_kernel_flag_kinds_and_rows(dev, m, kind):
    rflag, val = _resolve_leaves(m, m, 0, dev, kind)
    _same_scan((kbs.resolve_scan(rflag, val),),
               (kbs.resolve_scan_plain(rflag, val),))


@pytest.mark.parametrize("kind", ["photo", "mixed"])
def test_resolve_scan_at_a_4k_stream(dev, kind):
    """The 4K photo and mixed streams' round-0 leaves: the kernel equals
    the twin, 100 launches back to back equal the first, and
    `_decode_v2_device` launches it once a resolve (round 0 and each
    fixpoint round)."""
    make = getattr(testimages, kind)
    img = make(3840, 2160, 4, seed=3)
    s = oracle.encode(img, fmt.StreamDesc(3840, 2160, 4))
    data, clen = decode_v2.stream_body(s, dev)
    rflag, val = decode_v2.round0_leaves(data, clen)
    first = kbs.resolve_scan(rflag, val)
    _same_scan((first,), (kbs.resolve_scan_plain(rflag, val),))
    runs = [kbs.resolve_scan(rflag, val) for _ in range(100)]
    torch.cuda.synchronize()
    assert all(torch.equal(r, first) for r in runs)
    _build.reset_launches()
    npc = decode_pipeline.bucket_size(3840 * 2160)
    out, conv, rounds = decode_v2._decode_v2_device(data, clen, npc)
    torch.cuda.synchronize()
    assert _build.launches["resolve_scan"] == 1 + rounds
    if conv:
        want = torch.from_numpy(np.ascontiguousarray(
            img.reshape(-1, 4).T)).to(dev)
        assert torch.equal(out[:, : 3840 * 2160], want)


@pytest.mark.parametrize("ch", [3, 4])
def test_codec_on_card_matches_oracle(dev, ch):
    for name, img in testimages.edge_case_suite(ch).items():
        h, w = img.shape[:2]
        want = oracle.encode(img, fmt.StreamDesc(w, h, ch))
        assert qoi_tpu_torch.encode(img, device=dev) == want, name
        got, _ = qoi_tpu_torch.decode(want, device=dev)
        np.testing.assert_array_equal(got, oracle.decode(want)[0], name)


def test_batch_on_card_4k(dev):
    """encode_batch / decode_batch on a batch of 4K frames: the oracle's
    bytes and the sources' pixels, the adversarial stream through the
    ladder and a corrupted one as an error, through the compact_words,
    block_maps and expand kernels."""
    from qoi_tpu_torch.models import batch

    w, h = 3840, 2160
    frames = [testimages.mixed(w, h, 4, seed=s) for s in (3, 4)] + [
        testimages.photo(w, h, 3, seed=3)]
    want = [oracle.encode(f, fmt.StreamDesc(w, h, f.shape[2]))
            for f in frames]
    _build.reset_launches()
    assert batch.encode_batch(frames, device=dev) == want
    assert _build.launches["compact_words"] >= len(frames)
    adv = (fmt.pack_header(fmt.StreamDesc(640, 480, 4))
           + b"\x05" * (640 * 480) + fmt.TRAILER)
    bad = b"qoiX" + want[0][4:]
    _build.reset_launches()
    res = batch.decode_batch(want + [adv, bad], device=dev)
    for (img, desc, err), frame in zip(res, frames + [oracle.decode(adv)[0]]):
        assert err is None
        np.testing.assert_array_equal(img, frame)
    assert res[-1][:2] == (None, None) and "magic" in res[-1][2]
    assert _build.launches["block_maps"] > 0
    assert _build.launches["expand_px"] >= len(frames)


@pytest.mark.parametrize("engine,needs", [
    ("tpu", ("compact_words", "block_maps", "expand_px")),
    ("scan", ("encode_scan", "decode_scan"))])
def test_cli_on_card(dev, tmp_path, engine, needs):
    """The converter CLI, .qoi -> .qoi verified against the oracle, on the
    card (its default device), through the engine's kernels."""
    from qoi_tpu_torch import cli

    img = testimages.mixed(1920, 1080, 4, seed=2)
    stream = oracle.encode(img, fmt.StreamDesc(1920, 1080, 4))
    (tmp_path / "a.qoi").write_bytes(stream)
    _build.reset_launches()
    assert cli.main([str(tmp_path / "a.qoi"), str(tmp_path / "b.qoi"),
                     "--verify", "--engine", engine]) == 0
    assert (tmp_path / "b.qoi").read_bytes() == stream
    for name in needs:
        assert _build.launches[name] > 0, name


def test_profiling_on_card(dev, tmp_path):
    """utils.profiling on the card: the trace holds the encode's kernels
    and the annotation; device_sync_time synchronizes the card."""
    import json

    from qoi_tpu_torch.utils import profiling

    img = testimages.mixed(48, 32, 4, seed=1)
    want = oracle.encode(img, fmt.StreamDesc(48, 32, 4))
    with profiling.trace(tmp_path, device=dev):
        with profiling.annotate("qoi_encode"):
            got = qoi_tpu_torch.encode(img, device=dev)
    assert got == want
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    assert sum(ev.get("cat") == "kernel" for ev in events) > 0
    assert any(ev.get("name") == "qoi_encode" for ev in events)
    t = profiling.device_sync_time(
        lambda: qoi_tpu_torch.encode(img, device=dev), reps=2, device=dev)
    assert 0 < t < 10


def test_spans_under_emit_nvtx(dev, monkeypatch):
    """Under emit_nvtx (the route to Nsight Systems) the profiler counts as
    on, so each of the port's spans enters record_function, which emits
    its NVTX range; with nothing running, none does."""
    real = torch.profiler.record_function
    entered = []

    def counting(name):
        entered.append(name)
        return real(name)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    px = torch.from_numpy(testimages.mixed(48, 32, 4, seed=1)
                          .reshape(-1, 4).copy()).to(dev)
    pipeline.encode_device_wordsum(px, px.shape[0])
    assert entered == []
    with torch.autograd.profiler.emit_nvtx():
        pipeline.encode_device_wordsum(px, px.shape[0])
    torch.cuda.synchronize()
    assert entered == ["qoi.encode", "qoi.encode.stage_chunks",
                       "qoi.encode.compact"]
