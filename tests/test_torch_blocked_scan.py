"""kernels/blocked_scan.py on the CPU: the plain twins of the decode's
scans and the algebra of their one-pass CUDA kernel, against the JAX
package. The tolerance is exact equality (integer maps).

- Each maps twin (fsm_scan_plain, initial_scan_plain, anch_scan_plain)
  equals `blocked_scan` of the JAX combine at lengths that cross both of
  its branches (associative_scan up to 4 x 512, the lax.scan form above)
  and the kernel's tile edges (4096 leaves, 8192 bytes): random inputs
  and real streams.
- fsm_starts_plain equals JAX's `chunk_starts_and_state`, and
  initial_w_scan_plain JAX's `_initial_w(*_fields(data, clen)[1:5],
  entry_px32, npix=npix)`, on photo, mixed and adversarial streams,
  random bytes, chunks_len short of the bytes, streams whose last chunk
  starts in their final 4 bytes (the literals read past M), a non-seed
  entry px and views one byte off.
- A plain-torch model of the one-pass kernel (csrc/blocked_scan.cu: the
  staged 16-byte chunks of a row that starts `lead` bytes past a 16-byte
  boundary and each thread's words taken from them by word select and
  funnel shift; each thread's fold, by the FSM's digit step, the bytes
  form's per-op update or the combine; warp scans of shuffles and the
  warp totals' scan; the tiles run as the kernel's blocks in an order a
  seeded generator picks, each publishing its aggregate, looking back
  over windows of status words that are not ready, aggregates or
  inclusive, and publishing its inclusive prefix; each thread's prefix
  applied to the entry state and walked, or folded again) equals the
  same results for all five forms, at the kernel's geometry and at a
  small one whose rows hold many more tiles than a look-back window.
- On CPU tensors the wrappers take the twins, launch nothing, and reject
  wrong dtypes and shapes.
"""
import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qoi_tpu.models import decode_v3 as jd3
from qoi_tpu.ops import fsm as jfsm
from qoi_tpu.ops import scans as jscans
from qoi_tpu.utils import testimages
from qoi_tpu_torch import format as fmt
from qoi_tpu_torch import oracle
from qoi_tpu_torch.kernels import _build
from qoi_tpu_torch.kernels import blocked_scan as tbs
from qoi_tpu_torch.models import decode_v3 as td3
from torch_testutil import as_u32, require_oracle, to_torch

#: both branches of JAX's blocked_scan (n <= 2048: associative_scan) and
#: the kernel's tile edges (TILE_LEAVES = 4096, TILE_BYTES = 8192)
LENGTHS = [1, 2, 511, 2048, 2049, 4097, 70001]

#: the JAX combine of `_initial_w` is local to it; this is that function
_JAX_INITIAL_COMB = types.FunctionType(
    next(c for c in jd3._initial_w.__code__.co_consts
         if isinstance(c, types.CodeType) and c.co_name == "comb"),
    vars(jd3))

#: a non-seed entry px (packed r | g << 8 | b << 16 | a << 24)
ENTRY_PX = 0x7F3A11C5


@functools.lru_cache(maxsize=None)
def _jax_scan(kind):
    """The JAX package's blocked_scan of each combine, its
    chunk_starts_and_state, `_initial_w` of `_fields` and `_fields`,
    jitted."""
    if kind == "fsm":
        return jax.jit(lambda data: jscans.blocked_scan(
            jfsm._compose_maps, jfsm._pack_map(jfsm.chunk_byte_len(data) - 1)))
    if kind == "initial":
        return jax.jit(lambda leaf, npix: jscans.blocked_scan(
            lambda a, b: (_JAX_INITIAL_COMB(a[0], b[0]), a[1] + b[1]),
            (leaf, npix)))
    if kind == "starts":
        return jax.jit(jfsm.chunk_starts_and_state)
    if kind == "fields":
        return jax.jit(jd3._fields)
    if kind == "bytes":
        def initial_w(data, clen, entry):
            starts, cls, r6, d32, lit32, npix = jd3._fields(data, clen)
            return jd3._initial_w(cls, r6, d32, lit32, entry, npix=npix)
        return jax.jit(initial_w)
    return jax.jit(lambda leaf: jscans.blocked_scan(jd3._anch_comb, leaf))


# ---- inputs ------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _stream_body(content: str) -> np.ndarray:
    """A real stream's chunk bytes (header cut, trailer kept); the
    adversarial one is INDEX 5 at every pixel, a never-written slot."""
    require_oracle()
    if content == "adversarial":
        return np.full(200 * 120 + fmt.TRAILER_SIZE, 5, np.uint8)
    img = {"mixed": lambda: testimages.mixed(200, 120, 4, seed=5),
           "photo": lambda: testimages.photo(200, 120, 3, seed=3)}[content]()
    h, w, ch = img.shape
    s = oracle.encode(img, fmt.StreamDesc(w, h, ch))
    return np.frombuffer(s, np.uint8)[fmt.HEADER_SIZE:]


def _bytes(source: str, n: int) -> np.ndarray:
    if source == "random":
        return np.random.default_rng(n).integers(0, 256, n).astype(np.uint8)
    body = _stream_body(source)
    return np.resize(body, n).astype(np.uint8)   # repeats past its end


@functools.lru_cache(maxsize=None)
def _jax_fields(source: str, n: int):
    """JAX `_fields` of the first n bytes of a real stream, as numpy (the
    fields of at least 8 bytes, cut to n: `_fields` reads 4 ahead)."""
    data = _bytes(source, max(n, 8))
    return tuple(np.asarray(x)[:n] for x in _jax_scan("fields")(
        jnp.asarray(data), jnp.int32(n)))


def _initial_inputs(source: str, n: int):
    """(leaf, npix) int32: from JAX `_fields` of a real stream (the port's
    `_initial_leaf` packs them), or random bits in every field."""
    if source == "random":
        rng = np.random.default_rng(n + 1)
        leaf = (rng.integers(0, 2, n) | rng.integers(0, 2, n) << 1
                | rng.integers(0, 64, n) << 2 | rng.integers(0, 64, n) << 8
                | rng.integers(0, 256, n) << 14)
        return leaf.astype(np.int32), rng.integers(0, 63, n).astype(np.int32)
    _, cls, r6, d32, lit32, npix = _jax_fields(source, n)
    leaf = td3._initial_leaf(*(to_torch(x).long()
                               for x in (cls, r6, d32, lit32)))
    return leaf.numpy().astype(np.int32), npix.astype(np.int32)


def _anch_inputs(source: str, shape):
    """(R, L) int32 (g, e) leaves: random 7-bit, or `_anch_leaf` of a
    real stream's fields with random px."""
    n = int(np.prod(shape))
    rng = np.random.default_rng(n + 2)
    if source == "random":
        return rng.integers(0, 128, shape).astype(np.int32)
    _, cls, r6, d32, _, _ = (to_torch(x).long()
                             for x in _jax_fields(source, n))
    px = torch.from_numpy(rng.integers(0, 1 << 32, n, dtype=np.uint64)
                          .astype(np.int64))
    leaf = td3._anch_leaf(cls, r6, d32, px)
    return leaf.numpy().astype(np.int32).reshape(shape)


def _entry(name):
    return None if name == "seed" else torch.tensor(ENTRY_PX)


def _jax_bytes_form(data: np.ndarray, clen: int, entry: str):
    """JAX's `_initial_w` of the bytes' `_fields`, from the entry px (the
    seed px given explicitly hashes as the default). JAX's `_fields`
    reads 4 bytes ahead and needs at least 4: a shorter row is padded
    with zeros, which is what it reads past M, and the result cut."""
    n = data.shape[0]
    pad = np.zeros(max(n, 8), np.uint8)
    pad[:n] = data
    px = ENTRY_PX if entry == "px" else 0xFF000000
    return tuple(np.asarray(x)[:n] for x in _jax_scan("bytes")(
        jnp.asarray(pad), jnp.int32(clen), jnp.uint32(px)))


@functools.lru_cache(maxsize=None)
def _case(kind, source, shape):
    """(torch inputs, JAX result as int64 numpy arrays) of one case. The
    starts and bytes forms take chunks_len = 3/4 of the bytes, and the
    bytes form a non-seed entry px on real streams."""
    if kind == "fsm":
        data = _bytes(source, shape)
        want = (_jax_scan("fsm")(jnp.asarray(data)),)
        args = (to_torch(data),)
    elif kind == "starts":
        data = _bytes(source, shape)
        clen = shape - shape // 4
        want = _jax_scan("starts")(jnp.asarray(data), jnp.int32(clen))
        args = (to_torch(data), clen)
    elif kind == "bytes":
        data = _bytes(source, shape)
        clen = shape - shape // 4
        entry = "seed" if source == "random" else "px"
        want = _jax_bytes_form(data, clen, entry)
        starts = np.asarray(_jax_scan("starts")(jnp.asarray(data),
                                                jnp.int32(clen))[0])
        args = (to_torch(data), to_torch(starts), _entry(entry))
    elif kind == "initial":
        leaf, npix = _initial_inputs(source, shape)
        want = _jax_scan("initial")(jnp.asarray(leaf), jnp.asarray(npix))
        args = (to_torch(leaf), to_torch(npix))
    else:
        leaf = _anch_inputs(source, shape)
        want = (_jax_scan("anch")(jnp.asarray(leaf)),)
        args = (to_torch(leaf),)
    return args, tuple(np.asarray(w).astype(np.int64) for w in want)


FSM_CASES = [("fsm", src, n) for src in ("random", "mixed", "photo")
             for n in LENGTHS]
INITIAL_CASES = [("initial", src, n) for src in ("random", "mixed", "photo")
                 for n in LENGTHS]
ANCH_CASES = ([("anch", "random", (1, n)) for n in LENGTHS]
              + [("anch", "mixed", (1, n)) for n in (2049, 70001)]
              + [("anch", src, (64, b)) for src in ("random", "mixed")
                 for b in (16, 2048, 8192)]
              + [("anch", "random", (3, 4097))])
CASES = FSM_CASES + INITIAL_CASES + ANCH_CASES


def _param(cases):
    return [pytest.param(*c, id=f"{c[0]}-{c[1]}-{c[2]}") for c in cases]


def _plain(kind, args):
    if kind == "fsm":
        return (tbs.fsm_scan_plain(*args),)
    if kind == "starts":
        return tbs.fsm_starts_plain(*args)
    if kind == "bytes":
        return tbs.initial_w_scan_plain(*args)
    if kind == "initial":
        return tbs.initial_scan_plain(*args)
    return (tbs.anch_scan_plain(*args),)


def _check_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        if g.dtype == torch.bool:
            np.testing.assert_array_equal(g.numpy(), w != 0)
        else:
            np.testing.assert_array_equal(as_u32(g), w & 0xFFFFFFFF
                                          if g.dtype == torch.int32 else w)


# ---- the twins against JAX ----------------------------------------------

@pytest.mark.parametrize("kind,source,shape", _param(CASES))
def test_twin_matches_jax_blocked_scan(kind, source, shape):
    args, want = _case(kind, source, shape)
    got = _plain(kind, args)
    assert got[0].dtype == torch.int32
    if kind == "initial":
        assert got[1].dtype == torch.int64
    _check_equal(got, want)


@functools.lru_cache(maxsize=None)
def _halo_cut(source: str) -> int:
    """A length at which the stream's last chunk is a literal (RGB or
    RGBA) that starts in the final 4 bytes, so that its bytes run past
    the end and read as zero."""
    body = _stream_body(source)
    starts = np.asarray(_jax_scan("starts")(
        jnp.asarray(body), jnp.int32(len(body) - fmt.TRAILER_SIZE))[0])
    lit = np.flatnonzero(starts & (body >= fmt.OP_RGB))
    return int(lit[len(lit) // 2]) + 2


def _form_input(source: str, variant):
    """(data, chunks_len) of a twin case: a whole stream body (its
    trailer past chunks_len), its first half, a cut inside a literal, the
    body one byte into a larger buffer (a view off alignment), or n
    random bytes."""
    if source == "random":
        return torch.from_numpy(_bytes("random", variant)), variant
    body = _stream_body(source)
    clen = len(body) - fmt.TRAILER_SIZE
    if variant == "body":
        return torch.from_numpy(body.copy()), clen
    if variant == "cut":
        return torch.from_numpy(body.copy()), clen // 2
    if variant == "halo":
        n = _halo_cut(source)
        return torch.from_numpy(body[:n].copy()), n
    buf = torch.zeros(len(body) + 1, dtype=torch.uint8)
    buf[1:] = torch.from_numpy(body.copy())
    return buf[1:], clen


FORM_CASES = [("photo", "body", "seed"), ("mixed", "body", "px"),
              ("adversarial", "body", "seed"), ("adversarial", "cut", "px"),
              ("random", 1, "seed"), ("random", 3, "px"),
              ("random", 4097, "px"), ("random", 70001, "seed"),
              ("mixed", "cut", "seed"), ("mixed", "halo", "px"),
              ("photo", "halo", "seed"), ("mixed", "off", "px")]


@pytest.mark.parametrize("source,variant,entry", FORM_CASES,
                         ids=[f"{s}-{v}-{e}" for s, v, e in FORM_CASES])
def test_starts_twin_matches_jax_chunk_starts_and_state(source, variant,
                                                        entry):
    data, clen = _form_input(source, variant)
    want = _jax_scan("starts")(jnp.asarray(data.numpy()), jnp.int32(clen))
    got = tbs.fsm_starts_plain(data, clen)
    assert got[0].dtype == torch.bool and got[1].dtype == torch.int8
    _check_equal(got, tuple(np.asarray(w).astype(np.int64) for w in want))


@pytest.mark.parametrize("source,variant,entry", FORM_CASES,
                         ids=[f"{s}-{v}-{e}" for s, v, e in FORM_CASES])
def test_bytes_twin_matches_jax_initial_w(source, variant, entry):
    """initial_w_scan_plain from the bytes and the JAX starts equals JAX's
    `_initial_w` of the bytes' `_fields`, and so does the port's
    `_initial_w` from its own fields."""
    data, clen = _form_input(source, variant)
    want = tuple(np.asarray(w).astype(np.int64) for w in
                 _jax_bytes_form(data.numpy(), clen, entry))
    starts = torch.from_numpy(np.array(
        _jax_scan("starts")(jnp.asarray(data.numpy()), jnp.int32(clen))[0]))
    got = tbs.initial_w_scan_plain(data, starts, _entry(entry))
    assert got[0].dtype == got[1].dtype == torch.int64
    _check_equal(got, want)
    fields = td3._fields(data, clen)
    assert torch.equal(fields[0], starts)
    _check_equal(td3._initial_w(*fields[1:], _entry(entry)), want)


# ---- the kernel's one-pass design, modelled in plain torch ---------------

#: (threads a block, look-back lanes, status words a lane reads): the
#: kernel's, and a small one whose long rows hold many more tiles than its
#: window
GEOMETRIES = {"kernel": (512, 32, 1), "small": (64, 4, 1)}
#: elements a thread (32 FSM bytes, 16 bytes of the bytes form, 8 initial
#: leaves, 16 anch leaves) and bytes an element
ITEMS = {"fsm": (32, 1), "starts": (32, 1), "bytes": (16, 1),
         "initial": (8, 4), "anch": (16, 4)}
#: the rows' offsets past a 16-byte boundary that the model stages from:
#: aligned, and one that takes the third staged chunk (bytes) or the
#: last word select (leaves)
LEADS = {1: (0, 13), 4: (0, 12)}

_NOT_READY, _AGG, _INC = 0, 1, 2
_FSM_ID = 1 << 3 | 2 << 6 | 3 << 9 | 4 << 12
_DIGIT0 = 0x1249
_M32 = 0xFFFFFFFF

_COMBS = {
    "fsm": lambda a, b: (tbs._compose_maps(a[0], b[0]),),
    "initial": lambda a, b: (tbs._initial_comb(a[0], b[0]), a[1] + b[1]),
    "anch": lambda a, b: (tbs._anch_comb(a[0], b[0]),),
}
_COMBS["starts"] = _COMBS["fsm"]
_COMBS["bytes"] = _COMBS["initial"]


def _where(mask, a, b):
    return tuple(torch.where(mask, x, y) for x, y in zip(a, b))


def _shfl_up(x, d):
    """__shfl_up_sync over the last axis (threads): lane l reads lane
    l - d of its own warp, and lanes below d read their own value."""
    lane = torch.arange(x[0].shape[-1]) % 32
    return _where(lane >= d, tuple(t.roll(d, -1) for t in x), x)


def _block_scan(comb, x):
    """The kernel's block_scan over the last axis (one value a thread):
    warp scans by shuffles up (lane >= d takes comb(x[t - d], x[t])),
    lane 31's totals scanned the same way, each warp after the first
    seeded with the totals before it. Returns (inclusive, the block's
    fold: its last thread's)."""
    nt = x[0].shape[-1]
    lane = torch.arange(nt) % 32
    d = 1
    while d < 32:
        x = _where(lane >= d, comb(_shfl_up(x, d), x), x)
        d <<= 1
    wt = tuple(t[..., 31::32] for t in x)
    nw = wt[0].shape[-1]
    wl = torch.arange(nw)
    d = 1
    while d < nw:
        wt = _where(wl >= d, comb(tuple(t.roll(d, -1) for t in wt), wt), wt)
        d <<= 1
    w = torch.arange(nt) // 32
    before = tuple(t[..., (w - 1).clamp(min=0)] for t in wt)
    x = _where(w > 0, comb(before, x), x)
    return x, tuple(t[..., -1] for t in x)


def _staged_words(row: np.ndarray, lead: int, tile_bytes: int, nt: int,
                  threads: int, nw: int) -> torch.Tensor:
    """(nt, threads, nw) words as each thread of each tile takes them: the
    tile's 16-byte chunks staged from a row placed `lead` bytes past a
    16-byte boundary (zero outside the row), then nw words from byte
    lead + t * tile_bytes / threads of the window, by a select of whole
    words (lead >> 2) and a funnel shift (8 * (lead & 3))."""
    nch = tile_bytes // 16 + 2
    pos = (np.arange(nt)[:, None] * tile_bytes - lead
           + np.arange(16 * nch)[None, :])
    ok = (pos >= 0) & (pos < row.size)
    win = np.where(ok, row[np.clip(pos, 0, row.size - 1)], 0).astype(np.int64)
    words = win[:, 0::4] | win[:, 1::4] << 8 | win[:, 2::4] << 16 \
        | win[:, 3::4] << 24
    ib = tile_bytes // threads
    q, r = lead >> 2, 8 * (lead & 3)
    idx = ((np.arange(threads) * ib // 16) * 4 + q)[:, None] \
        + np.arange(nw + 1)[None, :]
    sel = words[:, idx]
    lo, hi = sel[..., :-1], sel[..., 1:]
    out = lo if r == 0 else ((lo >> r) | (hi << (32 - r))) & _M32
    return torch.from_numpy(out)


def _byte(words: torch.Tensor, k: int) -> torch.Tensor:
    return (words[..., k >> 2] >> (8 * (k & 3))) & 0xFF


def _len1x4(x):
    """The kernel's fsm_len1x4: chunk_byte_len(b) - 1 of each byte of a
    word, in its byte (LUMA by bits 7 and 6; 0xFE and 0xFF as the bytes
    where ~x & 0xFE is zero, found without a borrow)."""
    luma = x & ~(x << 1) & 0x80808080
    y = ~x & 0xFEFEFEFE
    lit = ~(((y & 0x7F7F7F7F) + 0x7F7F7F7F) | y) & 0x80808080
    ff = lit & (x << 7)
    return (luma >> 7) + 3 * ((lit ^ ff) >> 7) + (ff >> 5)


def _fsm_step(m, l):
    """The kernel's fsm_step: every digit d -> d ? d - 1 : l, at once."""
    nz = (m | (m >> 1) | (m >> 2)) & _DIGIT0
    return (m - nz) | ((nz ^ _DIGIT0) * l)


def _chunk_op(x, lit, start):
    """The kernel's chunk_op: op | v << 3 | va << 9 | npix << 17."""
    b2, two = lit & 0xFF, x >> 6
    c3 = 3 * b2 + 5 * ((lit >> 8) & 0xFF) + 7 * ((lit >> 16) & 0xFF)
    diff = 3 * ((x >> 4) & 3) + 5 * ((x >> 2) & 3) + 7 * (x & 3) - 30
    luma = 15 * (x & 63) - 560 + 3 * (b2 >> 4) + 7 * (b2 & 15)
    rgb, rgba = x == 0xFE, x == 0xFF
    op = torch.where(rgb, 3, torch.where(rgba, 4, torch.where(
        two == 0, 2, torch.where(two == 3, 0, 1))))
    v = torch.where(rgb, c3, torch.where(rgba, c3 + 11 * (lit >> 24),
        torch.where(two == 0, x, torch.where(two == 1, diff, luma))))
    npix = torch.where((two == 3) & ~rgb & ~rgba, (x & 63) + 1, 1)
    va = torch.where(rgba, lit >> 24, 0)
    return torch.where(start, op | ((v & 63) << 3) | (va << 9)
                       | (npix << 17), 0)


def _fold_back(comb, vals, last):
    """The kernel's fold_back over the window's lanes (lane 0: the latest
    tile): lane l takes comb(x[l + d], x[l]) while l + d <= last; lane
    0's value."""
    lane = torch.arange(vals[0].shape[0])
    x, d = vals, 1
    while d < lane.shape[0]:
        y = tuple(torch.cat([t[d:], t[-d:]]) for t in x)
        x = _where(lane + d <= last, comb(y, x), x)
        d <<= 1
    return tuple(t[0] for t in x)


def _run_tiles(comb, aggs, lanes, peek, rng, seen):
    """The tiles of a row as the kernel's blocks run them. Tiles start in
    ticket order, at most 4 * lanes * peek at a time, and a seeded
    generator interleaves their steps. A tile publishes its aggregate
    (tile 0: its inclusive prefix) after a random number of steps, then
    looks back: it reads windows of lanes x peek status words back from
    the tile before it (lane l: the peek words from peek * l on, newest
    first), waits while the newest word that is not an aggregate is
    unpublished, folds each lane from its newest word to its stop and the
    lanes up to the first that stops (the kernel's fold_back), and slides
    back a window while all are aggregates; then it publishes its
    inclusive prefix. Returns each tile's exclusive prefix (tile 0's
    unused); `seen` counts waits, slides and finishes."""
    nt = aggs[0].shape[0]
    window = lanes * peek
    flag = [_NOT_READY] * nt
    val = [None] * nt
    ex = {}

    def agg(j):
        return tuple(t[j] for t in aggs)

    def zero():
        return tuple(torch.zeros_like(t[0]) for t in aggs)

    def tile(j):
        for _ in range(int(rng.integers(3))):
            yield
        flag[j], val[j] = (_INC if j == 0 else _AGG), agg(j)
        if j == 0:
            return
        yield
        hi, acc = j - 1, None
        while True:
            words = [[(flag[x], val[x]) if x >= 0 else (_INC, zero())
                      for x in (hi - peek * lane - i for i in range(peek))]
                     for lane in range(lanes)]
            firsts = [next((i for i, (f, _) in enumerate(w) if f != _AGG),
                           peek) for w in words]
            stops = [f < peek for f in firsts]
            last = stops.index(True) if any(stops) else lanes - 1
            if any(stops) and words[last][firsts[last]][0] != _INC:
                seen["wait"] += 1
                yield
                continue
            parts = []
            for w, first in zip(words, firsts):
                part = w[0][1] if w[0][1] is not None else zero()
                for i in range(1, min(first, peek - 1) + 1):
                    v = w[i][1] if w[i][1] is not None else zero()
                    part = comb(v, part)
                parts.append(part)
            vals = tuple(torch.stack([p[i] for p in parts])
                         for i in range(len(aggs)))
            w = _fold_back(comb, vals, last)
            acc = w if acc is None else comb(w, acc)
            if any(stops):
                break
            hi -= window
            seen["slide"] += 1
            yield
        ex[j] = acc
        flag[j], val[j] = _INC, comb(acc, agg(j))
        seen["done"] += 1

    pending, running = list(range(nt)), []
    while pending or running:
        if pending and len(running) < 4 * window and (
                not running or rng.random() < 0.3):
            running.append(tile(pending.pop(0)))
            continue
        co = running[int(rng.integers(len(running)))]
        try:
            next(co)
        except StopIteration:
            running.remove(co)
    ex[0] = zero()
    return tuple(torch.stack([ex[j][i] for j in range(nt)])
                 for i in range(len(aggs)))


def _one_pass_row(kind, row, extra, threads, lanes, peek, lead, rng, seen):
    """csrc/blocked_scan.cu on one row in plain torch. row: the row's
    bytes (uint8; for "bytes" the data, then the starts as a second row in
    `extra`); extra: chunks_len (starts), (starts bytes, entry px)
    (bytes), the npix bytes (initial). Returns the outputs, cut to the
    row's length."""
    items, esz = ITEMS[kind]
    comb = _COMBS[kind]
    n = row.size // esz
    tile = threads * items
    nt = -(-n // tile)
    tb = tile * esz
    t_id = torch.arange(threads)
    e = (torch.arange(nt)[:, None] * tile + t_id[None, :] * items)
    # -- staging and each thread's fold
    if kind in ("fsm", "starts"):
        lw = _len1x4(_staged_words(row, lead, tb, nt, threads, items // 4))
        ls = [_byte(lw, k) for k in range(items)]
        f = torch.full((nt, threads), _FSM_ID, dtype=torch.int64)
        for k in range(items):
            f = _fsm_step(f, ls[k])
        x = (f,)
    elif kind == "bytes":
        starts_row, entry = extra
        d = _staged_words(row, lead, tb, nt, threads, 5)
        s = _staged_words(starts_row, (lead + 5) % 16, tb, nt, threads, 4)
        d = torch.cat([d, torch.zeros_like(d[..., :1])], -1)
        ops = []
        for k in range(16):
            q, r = (k + 1) >> 2, (k + 1) & 3
            lit = d[..., q] if r == 0 else (
                (d[..., q] >> (8 * r)) | (d[..., q + 1] << (32 - 8 * r))) & _M32
            ops.append(_chunk_op(_byte(d, k), lit, _byte(s, k) != 0))
        z = torch.zeros((nt, threads), dtype=torch.int64)
        g, tt, ee, ra, va, ns = z + 1, z, z, z, z, z
        for o in ops:
            c, v = o & 7, (o >> 3) & 63
            set_ = c >= 2
            ev = torch.where((c == 3) & (ra != 0), v + 11 * va, v)
            ee = torch.where(c == 1, ee + v, torch.where(set_, ev, ee))
            tt = torch.where(c == 3, torch.where(ra != 0, 0, 11),
                             torch.where(set_, 0, tt))
            g = torch.where(set_, 0, g)
            va = torch.where(c == 4, (o >> 9) & 0xFF, va)
            ra = torch.where(c == 4, 1, ra)
            ns = ns + (o >> 17)
        x = (ra | g << 1 | tt << 2 | (ee & 63) << 8 | va << 14, ns)
    else:
        d = _staged_words(row, lead, tb, nt, threads, items)
        if kind == "initial":
            npix = _staged_words(extra, (lead + 4) % 16, tb, nt, threads,
                                 items)
            npix = torch.where(npix >= 1 << 31, npix - (1 << 32), npix)
            elems = [(d[..., k], npix[..., k]) for k in range(items)]
        else:
            elems = [(d[..., k],) for k in range(items)]
        x = elems[0]
        for k in range(1, items):
            x = comb(x, elems[k])
    # -- block scan, look-back, each thread's prefix
    inc, agg = _block_scan(comb, x)
    ex = _run_tiles(comb, agg, lanes, peek, rng, seen)
    excl = tuple(torch.cat([t[..., :1], t[..., :-1]], -1) for t in inc)
    tile_j = torch.arange(nt)[:, None].expand(nt, threads)
    exb = tuple(t[:, None].expand(nt, threads) for t in ex)
    first = (t_id == 0)[None, :].expand(nt, threads)
    pre = _where(tile_j > 0, _where(first, exb, comb(exb, excl)), excl)
    has = ~first | (tile_j > 0)
    # -- apply, or fold again
    if kind == "fsm":
        f = torch.where(has, pre[0], _FSM_ID)
        outs = []
        for k in range(items):
            f = _fsm_step(f, ls[k])
            outs.append(f)
        cols = (torch.stack(outs, -1).to(torch.int64),)
    elif kind == "starts":
        st = torch.where(has, pre[0] & 7, 0)
        sb, sv = [], []
        for k in range(items):
            sb.append(st)
            sv.append((st == 0) & (e + k < extra))
            st = torch.where(st != 0, st - 1, ls[k])
        cols = (torch.stack(sv, -1), torch.stack(sb, -1).to(torch.int8))
    elif kind == "bytes":
        px = 0xFF000000 if entry is None else int(entry)
        h0 = (3 * (px & 0xFF) + 5 * ((px >> 8) & 0xFF)
              + 7 * ((px >> 16) & 0xFF) + 11 * (px >> 24)) & 63
        a0 = px >> 24
        p = pre[0]
        h = torch.where(has, ((p >> 1) & 1) * h0 + ((p >> 2) & 63) * a0
                        + ((p >> 8) & 63), h0)
        al = torch.where(has & ((p & 1) != 0), (p >> 14) & 0xFF, a0)
        off = torch.where(has, pre[1], 0)
        ws, offs = [], []
        for o in ops:
            c, v = o & 7, (o >> 3) & 63
            h = torch.where(c == 1, h + v, torch.where(
                c == 3, v + 11 * al, torch.where(c >= 2, v, h)))
            al = torch.where(c == 4, (o >> 9) & 0xFF, al)
            ws.append(h & 63)
            offs.append(off)
            off = off + (o >> 17)
        cols = (torch.stack(ws, -1), torch.stack(offs, -1))
    else:
        acc, outs = pre, []
        for k in range(items):
            acc = _where(has | (k > 0), comb(acc, elems[k]), elems[k])
            outs.append(acc)
        cols = tuple(torch.stack([o[i] for o in outs], -1)
                     for i in range(len(x)))
    return tuple(c.reshape(-1)[:n] for c in cols)


def _model(kind, args, geometry, lead, seed=0):
    """The one-pass model of the wrapper of `kind` on its torch args:
    each row placed `lead` bytes past a 16-byte boundary, the tiles run in
    an order the seed picks. Returns (outputs, look-back counts)."""
    threads, lanes, peek = GEOMETRIES[geometry]
    rng = np.random.default_rng(seed)
    seen = {"wait": 0, "slide": 0, "done": 0}

    def as_bytes(t):
        return t.contiguous().numpy().view(np.uint8).reshape(-1)

    if kind in ("fsm", "starts"):
        extra = args[1] if kind == "starts" else None
        out = _one_pass_row(kind, as_bytes(args[0]), extra, threads, lanes,
                            peek, lead, rng, seen)
    elif kind == "bytes":
        data, starts, entry = args
        out = _one_pass_row(kind, as_bytes(data),
                            (as_bytes(starts.to(torch.uint8)), entry),
                            threads, lanes, peek, lead, rng, seen)
    elif kind == "initial":
        out = _one_pass_row(kind, as_bytes(args[0]), as_bytes(args[1]),
                            threads, lanes, peek, lead, rng, seen)
    else:
        rows = [_one_pass_row(kind, as_bytes(r), None, threads, lanes, peek,
                              lead, rng, seen) for r in args[0]]
        out = tuple(torch.stack([r[i] for r in rows])
                    for i in range(len(rows[0])))
    if kind in ("fsm", "initial", "anch"):   # int32 maps, as bit patterns
        out = (torch.where(out[0] >= 1 << 31, out[0] - (1 << 32),
                           out[0]).to(torch.int32),) + out[1:]
    return out, seen


MODEL_CASES = ([("fsm", src, n) for src in ("random", "mixed")
                for n in LENGTHS]
               + [("initial", src, n) for src in ("random", "mixed")
                  for n in LENGTHS]
               + [("anch", "random", (1, n)) for n in LENGTHS]
               + [("anch", src, (64, b)) for src in ("random", "mixed")
                  for b in (16, 8192)]
               + [("starts", src, n) for src in ("random", "mixed")
                  for n in LENGTHS]
               + [("bytes", src, n) for src in ("random", "mixed")
                  for n in LENGTHS])


@pytest.mark.parametrize("geometry", sorted(GEOMETRIES))
@pytest.mark.parametrize("kind,source,shape", _param(MODEL_CASES))
def test_kernel_model_matches_jax_blocked_scan(kind, source, shape,
                                               geometry):
    """The one-pass model equals JAX (blocked_scan of the combine, or
    chunk_starts_and_state, or _initial_w of the fields), from an aligned
    row and from one off alignment, in two tile orders."""
    args, want = _case(kind, source, shape)
    for seed, lead in enumerate(LEADS[ITEMS[kind][1]]):
        got, _ = _model(kind, args, geometry, lead, seed)
        _check_equal(got, want)


def test_kernel_model_takes_several_aggregate_chunks():
    """The look-back's chunks are its windows: at the small geometry the
    longest row holds many more tiles than a window, and its run waits on
    unpublished words, slides back over windows of aggregates and
    finishes every tile; at the kernel's geometry a tile is the kernel's
    (TILE_BYTES, TILE_LEAVES)."""
    threads, lanes, peek = GEOMETRIES["small"]
    nt = -(-max(LENGTHS) // (threads * ITEMS["bytes"][0]))
    assert nt > 8 * lanes * peek
    args, _ = _case("bytes", "mixed", max(LENGTHS))
    _, seen = _model("bytes", args, "small", 13, seed=3)
    assert seen["wait"] > 0 and seen["slide"] > 0
    assert seen["done"] == nt - 1
    threads, lanes, peek = GEOMETRIES["kernel"]
    assert threads * ITEMS["fsm"][0] == tbs.TILE_FSM
    assert threads * ITEMS["bytes"][0] == tbs.TILE_BYTES
    assert threads * ITEMS["initial"][0] == tbs.TILE_LEAVES
    assert threads * ITEMS["anch"][0] == tbs.TILE_ANCH


# ---- the wrappers on the CPU -----------------------------------------------

def test_wrappers_take_the_twins_on_the_cpu():
    _build.reset_launches()
    rng = np.random.default_rng(9)
    data = to_torch(rng.integers(0, 256, 5000).astype(np.uint8))
    assert torch.equal(tbs.fsm_scan(data), tbs.fsm_scan_plain(data))
    for g, w in zip(tbs.fsm_starts(data, 4000),
                    tbs.fsm_starts_plain(data, 4000)):
        assert torch.equal(g, w)
    starts = tbs.fsm_starts(data, 4000)[0]
    for e in (None, torch.tensor(ENTRY_PX)):
        for g, w in zip(tbs.initial_w_scan(data, starts, e),
                        tbs.initial_w_scan_plain(data, starts, e)):
            assert torch.equal(g, w)
    leaf = to_torch(rng.integers(0, 1 << 22, 5000).astype(np.int32))
    npix = to_torch(rng.integers(0, 63, 5000).astype(np.int32))
    for g, w in zip(tbs.initial_scan(leaf, npix),
                    tbs.initial_scan_plain(leaf, npix)):
        assert torch.equal(g, w)
    rows = to_torch(rng.integers(0, 128, (64, 300)).astype(np.int32))
    assert torch.equal(tbs.anch_scan(rows), tbs.anch_scan_plain(rows))
    assert all(_build.launches[k] == 0
               for k in ("fsm_scan", "fsm_starts", "initial_scan",
                         "initial_w_scan", "anch_scan"))


def test_rows_scan_independently():
    rng = np.random.default_rng(10)
    rows = to_torch(rng.integers(0, 128, (5, 777)).astype(np.int32))
    got = tbs.anch_scan(rows)
    for r in range(5):
        assert torch.equal(got[r], tbs.anch_scan(rows[r:r + 1])[0])


def test_empty_inputs():
    z8 = torch.zeros(0, dtype=torch.uint8)
    assert tbs.fsm_scan(z8).shape == (0,)
    starts, state = tbs.fsm_starts(z8, 0)
    assert starts.shape == state.shape == (0,)
    w, off = tbs.initial_w_scan(z8, torch.zeros(0, dtype=torch.bool))
    assert w.shape == off.shape == (0,)
    ps, inc = tbs.initial_scan(torch.zeros(0, dtype=torch.int32),
                               torch.zeros(0, dtype=torch.int32))
    assert ps.shape == inc.shape == (0,)
    assert tbs.anch_scan(torch.zeros((2, 0), dtype=torch.int32)).shape == (2, 0)


@pytest.mark.parametrize("call,exc", [
    (lambda: tbs.fsm_scan(torch.zeros(8, dtype=torch.int32)), TypeError),
    (lambda: tbs.fsm_scan(torch.zeros((2, 8), dtype=torch.uint8)),
     ValueError),
    (lambda: tbs.initial_scan(torch.zeros(8, dtype=torch.int64),
                              torch.zeros(8, dtype=torch.int32)), TypeError),
    (lambda: tbs.initial_scan(torch.zeros(8, dtype=torch.int32),
                              torch.zeros(7, dtype=torch.int32)), ValueError),
    (lambda: tbs.anch_scan(torch.zeros(8, dtype=torch.int32)), ValueError),
    (lambda: tbs.anch_scan(torch.zeros((2, 8), dtype=torch.int64)),
     TypeError),
    (lambda: tbs.fsm_starts(torch.zeros(8, dtype=torch.int32), 8),
     TypeError),
    (lambda: tbs.initial_w_scan(torch.zeros(8, dtype=torch.uint8),
                                torch.zeros(8, dtype=torch.uint8)),
     TypeError),
    (lambda: tbs.initial_w_scan(torch.zeros(8, dtype=torch.uint8),
                                torch.zeros(7, dtype=torch.bool)),
     ValueError),
    (lambda: tbs.initial_w_scan(torch.zeros(8, dtype=torch.uint8),
                                torch.zeros(8, dtype=torch.bool),
                                torch.tensor(5, dtype=torch.int32)),
     ValueError),
], ids=["fsm-dtype", "fsm-ndim", "initial-dtype", "initial-shapes",
        "anch-ndim", "anch-dtype", "starts-dtype", "bytes-starts-dtype",
        "bytes-shapes", "bytes-entry-dtype"])
def test_wrappers_reject_wrong_dtypes_and_shapes(call, exc):
    with pytest.raises(exc):
        call()
