"""kernels/blocked_scan.py on the CPU: the plain twins of the three
decode scans and the algebra of their CUDA kernel, against the JAX
package's `scans.blocked_scan` with the JAX combines. The tolerance is
exact equality (integer maps).

- Each twin (fsm_scan_plain, initial_scan_plain, anch_scan_plain) equals
  `blocked_scan` of the JAX combine at lengths that cross both of its
  branches (associative_scan up to 4 x 512, the lax.scan form above)
  and the kernel's tile edges (4096): random inputs and real streams.
- A plain-torch model of the kernel's decomposition (csrc/blocked_scan.cu:
  per-thread runs of consecutive elements, warp scans of shuffles, the
  warp totals' scan, the tile aggregates scanned in chunks with a carry,
  each thread's exclusive prefix seeded with the tiles before it, the
  ragged last tile masked) equals the same result, at the kernel's
  geometry and at a small one whose aggregate scan takes several chunks.
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
#: the kernel's tile edges (TILE = 4096)
LENGTHS = [1, 2, 511, 2048, 2049, 4097, 70001]

#: the JAX combine of `_initial_w` is local to it; this is that function
_JAX_INITIAL_COMB = types.FunctionType(
    next(c for c in jd3._initial_w.__code__.co_consts
         if isinstance(c, types.CodeType) and c.co_name == "comb"),
    vars(jd3))


@functools.lru_cache(maxsize=None)
def _jax_scan(kind):
    """The JAX package's blocked_scan of each combine, jitted."""
    if kind == "fsm":
        return jax.jit(lambda data: jscans.blocked_scan(
            jfsm._compose_maps, jfsm._pack_map(jfsm.chunk_byte_len(data) - 1)))
    if kind == "initial":
        return jax.jit(lambda leaf, npix: jscans.blocked_scan(
            lambda a, b: (_JAX_INITIAL_COMB(a[0], b[0]), a[1] + b[1]),
            (leaf, npix)))
    return jax.jit(lambda leaf: jscans.blocked_scan(jd3._anch_comb, leaf))


# ---- inputs ------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _stream_body(content: str) -> np.ndarray:
    """A real stream's chunk bytes (header cut, trailer kept)."""
    require_oracle()
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
    return tuple(np.asarray(x)[:n] for x in jd3._fields(
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


@functools.lru_cache(maxsize=None)
def _case(kind, source, shape):
    """(torch inputs, JAX result as int64 numpy arrays) of one case."""
    if kind == "fsm":
        data = _bytes(source, shape)
        want = (_jax_scan("fsm")(jnp.asarray(data)),)
        args = (to_torch(data),)
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
    if kind == "initial":
        return tbs.initial_scan_plain(*args)
    return (tbs.anch_scan_plain(*args),)


def _check_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
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


# ---- the kernel's decomposition, modelled in plain torch ----------------

#: (threads a block, elements a thread, threads of the aggregate scan):
#: the kernel's, and a small one (tiles of 256, aggregates scanned 64 at
#: a time, so that a long row takes several chunks with a carry)
GEOMETRIES = {"kernel": (256, 16, 1024), "small": (64, 4, 64)}

_COMBS = {
    "fsm": lambda a, b: (tbs._compose_maps(a[0], b[0]),),
    "initial": lambda a, b: (tbs._initial_comb(a[0], b[0]), a[1] + b[1]),
    "anch": lambda a, b: (tbs._anch_comb(a[0], b[0]),),
}


def _where(mask, a, b):
    return tuple(torch.where(mask, x, y) for x, y in zip(a, b))


def _shfl_up(x, d):
    """__shfl_up_sync over the last axis (threads): lane l reads lane
    l - d of its own warp, and lanes below d read their own value."""
    lane = torch.arange(x[0].shape[-1]) % 32
    return _where(lane >= d, tuple(t.roll(d, -1) for t in x), x)


def _block_scan(comb, x, nvalid):
    """The kernel's block_scan over the last axis (one value a thread):
    warp scans by shuffles up (lane >= d takes comb(x[t - d], x[t])),
    lane 31's totals scanned the same way, each warp after the first
    seeded with the totals before it. Returns (inclusive, the warps'
    scanned totals, the total at thread nvalid - 1)."""
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
    last = (nvalid - 1).clamp(min=0)[..., None]
    tot = tuple(t.gather(-1, last)[..., 0] for t in x)
    return x, wt, tot


def _agg_scan(comb, aggs, threads):
    """agg_scan_kernel: each row's tile aggregates scanned in place,
    `threads` at a time, each chunk after the first seeded with the
    carry."""
    ns = aggs[0].shape[-1]
    out, carry = [], None
    for c in range(0, ns, threads):
        k = min(threads, ns - c)
        chunk = tuple(torch.nn.functional.pad(t[..., c:c + k],
                                              (0, threads - k)) for t in aggs)
        nvalid = torch.full(chunk[0].shape[:-1], k)
        x, _, tot = _block_scan(comb, chunk, nvalid)
        if carry is not None:
            x = comb(tuple(t[..., None] for t in carry), x)
        out.append(tuple(t[..., :k] for t in x))
        carry = tot if carry is None else comb(carry, tot)
    return tuple(torch.cat([o[i] for o in out], -1)
                 for i in range(len(aggs)))


def _kernel_model(comb, leaves, threads, items, agg_threads):
    """csrc/blocked_scan.cu in plain torch on (R, L) leaves (a tuple of
    int64 planes): reduce, scan the tile aggregates, scan each tile
    seeded with the tiles before it."""
    tile = threads * items
    rows, length = leaves[0].shape
    nt = -(-length // tile)
    # the kernel never reads past L; zeros here are masked by the counts
    x = tuple(torch.nn.functional.pad(t, (0, nt * tile - length))
              .reshape(rows, nt, threads, items) for t in leaves)
    n = (length - torch.arange(nt) * tile).clamp(max=tile)       # (nt,)
    first = torch.arange(threads) * items
    cnt = (n[:, None] - first[None, :]).clamp(max=items)         # (nt, T)
    cnt = cnt.expand(rows, nt, threads)
    nvalid = (-(-n // items)).expand(rows, nt)

    # each thread's fold of its run; threads with no element hold 0
    agg = tuple(t[..., 0] for t in x)
    for k in range(1, items):
        agg = _where(k < cnt, comb(agg, tuple(t[..., k] for t in x)), agg)
    agg = _where(cnt > 0, agg, tuple(torch.zeros_like(t) for t in agg))
    inc, wt, tot = _block_scan(comb, agg, nvalid)

    # each thread's exclusive prefix: the thread before it in its warp,
    # else the warp totals before its warp, then the tiles before its tile
    t_id = torch.arange(threads)
    w = t_id // 32
    acc = _shfl_up(inc, 1)
    acc = _where(t_id % 32 == 0, tuple(
        t[..., (w - 1).clamp(min=0)] for t in wt), acc)
    has = (t_id > 0).expand(rows, nt, threads)
    if nt > 1:
        # the reduce pass's aggregates (every tile but the last), scanned
        scanned = _agg_scan(comb, tuple(t[:, :nt - 1] for t in tot),
                            agg_threads)
        seed = tuple(torch.cat([t[:, :1], t], 1)[..., None].expand(
            rows, nt, threads) for t in scanned)     # tile j: scanned[j-1]
        tile_j = torch.arange(nt)[:, None].expand(nt, threads)
        acc = _where(tile_j > 0, _where(has, comb(seed, acc), seed), acc)
        has = has | (tile_j > 0)

    out = []
    for k in range(items):
        v = tuple(t[..., k] for t in x)
        acc = _where(has | (k > 0), comb(acc, v), v)
        out.append(acc)
    return tuple(torch.stack([o[i] for o in out], -1)
                 .reshape(rows, nt * tile)[:, :length]
                 for i in range(len(leaves)))


MODEL_CASES = ([("fsm", src, n) for src in ("random", "mixed")
                for n in LENGTHS]
               + [("initial", src, n) for src in ("random", "mixed")
                  for n in LENGTHS]
               + [("anch", "random", (1, n)) for n in LENGTHS]
               + [("anch", src, (64, b)) for src in ("random", "mixed")
                  for b in (16, 8192)])


@pytest.mark.parametrize("geometry", sorted(GEOMETRIES))
@pytest.mark.parametrize("kind,source,shape", _param(MODEL_CASES))
def test_kernel_model_matches_jax_blocked_scan(kind, source, shape,
                                               geometry):
    args, want = _case(kind, source, shape)
    if kind == "fsm":
        leaves = (tbs._pack_map(tbs.chunk_byte_len(args[0]) - 1)[None],)
    elif kind == "initial":
        leaves = (args[0].long()[None] & 0xFFFFFFFF, args[1].long()[None])
    else:
        leaves = (args[0].long() & 0xFFFFFFFF,)
    got = _kernel_model(_COMBS[kind], leaves, *GEOMETRIES[geometry])
    if kind != "anch":
        got = tuple(g[0] for g in got)
    _check_equal(got, want)


def test_kernel_model_takes_several_aggregate_chunks():
    """The small geometry's longest row has more tile aggregates than its
    aggregate scan has threads, so the carry between chunks is used."""
    threads, items, agg_threads = GEOMETRIES["small"]
    assert -(-max(LENGTHS) // (threads * items)) - 1 > 2 * agg_threads
    threads, items, agg_threads = GEOMETRIES["kernel"]
    assert threads * items == tbs.TILE


# ---- the wrappers on the CPU -----------------------------------------------

def test_wrappers_take_the_twins_on_the_cpu():
    _build.reset_launches()
    rng = np.random.default_rng(9)
    data = to_torch(rng.integers(0, 256, 5000).astype(np.uint8))
    assert torch.equal(tbs.fsm_scan(data), tbs.fsm_scan_plain(data))
    leaf = to_torch(rng.integers(0, 1 << 22, 5000).astype(np.int32))
    npix = to_torch(rng.integers(0, 63, 5000).astype(np.int32))
    for g, w in zip(tbs.initial_scan(leaf, npix),
                    tbs.initial_scan_plain(leaf, npix)):
        assert torch.equal(g, w)
    rows = to_torch(rng.integers(0, 128, (64, 300)).astype(np.int32))
    assert torch.equal(tbs.anch_scan(rows), tbs.anch_scan_plain(rows))
    assert all(_build.launches[k] == 0
               for k in ("fsm_scan", "initial_scan", "anch_scan"))


def test_rows_scan_independently():
    rng = np.random.default_rng(10)
    rows = to_torch(rng.integers(0, 128, (5, 777)).astype(np.int32))
    got = tbs.anch_scan(rows)
    for r in range(5):
        assert torch.equal(got[r], tbs.anch_scan(rows[r:r + 1])[0])


def test_empty_inputs():
    assert tbs.fsm_scan(torch.zeros(0, dtype=torch.uint8)).shape == (0,)
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
], ids=["fsm-dtype", "fsm-ndim", "initial-dtype", "initial-shapes",
        "anch-ndim", "anch-dtype"])
def test_wrappers_reject_wrong_dtypes_and_shapes(call, exc):
    with pytest.raises(exc):
        call()
