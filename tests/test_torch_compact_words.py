"""The word compaction kernel of qoi_tpu_torch (csrc/compact_words.cu,
kernels/compact_words.py) on the CPU: its plain twin and a Python model of
the kernel against `compact_words6_wordsum`'s CPU route (the word-sum
events, the slide's twin and the windowed add), and through that route
against qoi_tpu's JAX function, word for word over the whole
(capacity // 4,) buffer, at the tile-edge geometries of
tests/compact_cases.py.

The model runs the kernel's steps on a tile of 8 threads of 8 records
(its own tile is 512 x 8): the tile byte counts, the look-back window
over status words of which a seeded share are still aggregates, each
thread's packer with its plain and atomicOr stores into the tile's
shared words, the 16-byte run of whole words and the element stores at
its edges, the shared words ORed into the output, and the trailing word
written by the tile that finishes last, the tiles finishing in a seeded
order. It checks that no word is both stored and ORed and that every
whole word is stored once."""
import pathlib
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from qoi_tpu.ops import compact as jcompact
from qoi_tpu_torch._bits import M32
from qoi_tpu_torch.kernels import _build
from qoi_tpu_torch.kernels import compact_words as kcw
from qoi_tpu_torch.ops import compact
from compact_cases import CASES, case

#: the model's tile: threads x records a thread
MODEL_THREADS, MODEL_PER = 8, 8
MODEL_TILE = MODEL_THREADS * MODEL_PER


def _same(got, want):
    (wg, tg), (ww, tw) = got, want
    assert wg.dtype == ww.dtype == torch.int32
    assert wg.shape == ww.shape
    assert int(tg) == int(tw)
    assert torch.equal(wg, ww)


def _look_back(view, j):
    """The kernel's look_back: lane l reads tile hi - l; stop at the first
    word that is not an aggregate (before tile 0: inclusive 0)."""
    hi, acc = j - 1, 0
    while True:
        words = [view[hi - l] if hi - l >= 0 else ("inc", 0)
                 for l in range(32)]
        stop = [l for l, (flag, _) in enumerate(words) if flag != "agg"]
        if stop:
            return (acc + sum(v for _, v in words[:stop[0] + 1])) & M32
        acc = (acc + sum(v for _, v in words)) & M32
        hi -= 32


def kernel_model(lo, hi, lens, capacity, seed=0, threads=MODEL_THREADS,
                 per=MODEL_PER):
    """The kernel's arithmetic on a (threads x per)-record tile; returns
    (words int32, total) as the wrapper does."""
    rng = np.random.default_rng(seed)
    n = lens.shape[0]
    tile = threads * per
    tiles = -(-n // tile)
    w_cap = capacity // 4
    sm_words = tile * 6 // 4 + 8
    pad = tiles * tile - n
    ln = np.minimum(np.concatenate([lens.numpy(), np.zeros(pad, np.int64)]),
                    6).astype(np.int64)
    lo = np.concatenate([lo.numpy() & M32, np.zeros(pad, np.int64)])
    hi = np.concatenate([hi.numpy() & M32, np.zeros(pad, np.int64)])
    t_bytes = ln.reshape(tiles, tile).sum(axis=1)

    # 4. the look-back, tiles in ticket order; a seeded share of the
    # earlier tiles' words still aggregates
    status, base = [], []
    for j in range(tiles):
        if j == 0:
            ex = 0
        else:
            view = [("agg", int(t_bytes[i])) if i and rng.random() < 0.7
                    else status[i] for i in range(j)]
            ex = _look_back(view, j)
        status.append(("inc", ex + int(t_bytes[j])))
        base.append(ex)

    out = np.zeros(w_cap, np.int64)
    stored = np.zeros(w_cap, np.int64)
    ored = np.zeros(w_cap, bool)
    word_sum, total, done = 0, None, 0
    for j in rng.permutation(tiles):
        e, t = base[j], int(t_bytes[j])
        i_end = e + t
        base_w = (e >> 2) & ~3
        sm = np.zeros(sm_words, np.int64)
        sm_plain = np.zeros(sm_words, np.int64)
        sm_or = np.zeros(sm_words, bool)
        recs = ln[j * tile:(j + 1) * tile].reshape(threads, per)
        mine = recs.sum(axis=1)
        loc = np.cumsum(mine) - mine
        # 5. each thread's packer
        for th in range(threads):
            pos = e + int(loc[th])
            w, have, acc = (pos >> 2) - base_w, (pos & 3) * 8, 0
            shared_first = (pos & 3) != 0
            for k in range(per):
                r = j * tile + th * per + k
                l = int(ln[r])
                if l == 0:
                    continue
                parts = [(lo[r] & ((1 << (8 * min(l, 4))) - 1), min(l, 4))]
                if l > 4:
                    parts.append((hi[r] & ((1 << (8 * (l - 4))) - 1), l - 4))
                for bits, nb in parts:
                    acc |= int(bits) << have
                    have += 8 * nb
                    if have >= 32:
                        if shared_first:
                            sm[w] |= acc & M32
                            sm_or[w] = True
                        else:
                            sm[w] = acc & M32
                            sm_plain[w] += 1
                        shared_first = False
                        w += 1
                        acc >>= 32
                        have -= 32
            if mine[th] > 0 and have > 0:
                sm[w] |= acc & M32
                sm_or[w] = True
        assert not (sm_or & (sm_plain > 0)).any()
        assert (sm_plain <= 1).all()
        # 6. out; 7. the sum of the tile's words
        part = 0
        if t > 0:
            g0, gl = e >> 2, (i_end - 1) >> 2
            part = int(sm[g0 - base_w:gl - base_w + 1].sum())
            head, tail = (e & 3) != 0, (i_end & 3) != 0
            if head and g0 < w_cap:
                out[g0] |= sm[g0 - base_w]
                ored[g0] = True
            if tail and not (head and gl == g0) and gl < w_cap:
                out[gl] |= sm[gl - base_w]
                ored[gl] = True
            wa = (e + 3) >> 2
            wb = min(i_end >> 2, w_cap)
            a4, b4 = (wa + 3) & ~3, wb & ~3
            v0 = a4 if a4 < b4 else max(wa, wb)
            v1 = b4 if a4 < b4 else v0
            for g4 in range(v0 // 4, v1 // 4):
                for g in range(4 * g4, 4 * g4 + 4):
                    out[g] = sm[g - base_w]
                    stored[g] += 1
            for k in range(8):          # threads 64 .. 71
                if wa + k < v0:
                    out[wa + k] = sm[wa + k - base_w]
                    stored[wa + k] += 1
            for k in range(4):          # threads 96 .. 99
                if v1 + k < wb:
                    out[v1 + k] = sm[v1 + k - base_w]
                    stored[v1 + k] += 1
            assert (stored[wa:wb] == 1).all()
        word_sum = (word_sum + part) & M32
        if j == tiles - 1:
            total = i_end
        done += 1
        if done == tiles:
            w_t = (total + 3) >> 2
            if w_t < w_cap:
                out[w_t] = (-word_sum) & M32
                stored[w_t] += 1
    assert not (ored & (stored > 0)).any()
    assert (stored <= 1).all()
    words = torch.from_numpy(np.where(out >= 1 << 31, out - (1 << 32), out)
                             .astype(np.int32))
    return words, torch.tensor(total, dtype=torch.int64)


def test_geometry_is_the_kernels():
    """TILE and the scratch's head agree with the kernel source."""
    src = (pathlib.Path(kcw.__file__).parent.parent / "csrc"
           / "compact_words.cu").read_text()
    assert int(re.search(r"constexpr int kTile = (\d+);", src)[1]) == \
        kcw.TILE
    assert int(re.search(r"constexpr int kHead = (\d+);", src)[1]) == \
        kcw._HEAD
    threads = int(re.search(r"constexpr int kThreads = (\d+);", src)[1])
    # the edge stores use threads 64 .. 71 and 96 .. 99
    assert threads >= 100 and kcw.TILE % threads == 0


@pytest.mark.parametrize("tile", [kcw.TILE, MODEL_TILE])
@pytest.mark.parametrize("name", sorted(CASES))
def test_twin_matches_cpu_route(name, tile):
    """The twin at the kernel's tile and at the model's, on cases cut at
    either tile, equals compact_words6_wordsum's CPU route word for word
    over the whole buffer."""
    lo, hi, lens, cap = case(name, tile)
    want = compact.compact_words6_wordsum(lo, hi, lens, cap)
    _same(kcw.compact_words_plain(lo, hi, lens, cap, tile=tile), want)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("name", sorted(CASES))
def test_kernel_model_matches_cpu_route(name, seed):
    lo, hi, lens, cap = case(name, MODEL_TILE)
    want = compact.compact_words6_wordsum(lo, hi, lens, cap)
    _same(kernel_model(lo, hi, lens, cap, seed=seed), want)


@pytest.mark.parametrize("name", ["mixed-tile-plus-one", "straddle-exact",
                                  "mod2"])
def test_twin_matches_jax(name):
    """The twin at the model's tile against qoi_tpu's jitted
    compact_words6_wordsum, over the whole buffer."""
    lo, hi, lens, cap = case(name, MODEL_TILE)
    fn = jax.jit(jcompact.compact_words6_wordsum,
                 static_argnames=("capacity", "seg", "words_out"))
    ww, tw = fn(jnp.asarray(lo.numpy().astype(np.uint32)),
                jnp.asarray(hi.numpy().astype(np.uint32)),
                jnp.asarray(lens.numpy().astype(np.int32)), capacity=cap,
                seg=lo.shape[0], words_out=True)
    wt, tt = kcw.compact_words_plain(lo, hi, lens, cap, tile=MODEL_TILE)
    assert int(tw) == int(tt)
    np.testing.assert_array_equal(np.asarray(ww).view(np.int32), wt.numpy())


@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
def test_wrapper_on_cpu_takes_both_dtypes(dtype):
    """compact_words on CPU tensors is the twin, for int32 bit patterns
    (the staging kernel's form) and int64 u32 values alike; it launches
    nothing."""
    lo, hi, lens, cap = case("mixed-tile-plus-one")
    want = compact.compact_words6_wordsum(lo, hi, lens, cap)
    if dtype == torch.int32:
        lo = torch.where(lo >= 1 << 31, lo - (1 << 32), lo)
    before = dict(_build.launches)
    _same(kcw.compact_words(lo.to(dtype), hi.to(dtype), lens.to(dtype), cap),
          want)
    assert _build.launches == before


def test_wrapper_refuses_bad_arguments():
    lo, hi, lens, cap = case("one-record", MODEL_TILE)
    with pytest.raises(ValueError, match="multiple of 4"):
        kcw.compact_words(lo, hi, lens, cap + 2)
    with pytest.raises(ValueError, match="multiple of 4"):
        compact.compact_words6_wordsum(lo, hi, lens, cap + 2)
    with pytest.raises(ValueError, match="shapes"):
        kcw.compact_words(lo, hi[:0], lens, cap)
    z = torch.zeros(0, dtype=torch.int64)
    words, total = kcw.compact_words(z, z, z, 8)
    assert int(total) == 0 and not words.any() and words.shape == (2,)
