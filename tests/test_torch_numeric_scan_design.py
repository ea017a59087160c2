"""The algebra of the numeric_scan kernel's design, on the CPU.

The CUDA kernel (qoi_tpu_torch/csrc/numeric_scan.cu) runs only on the card,
where tests/test_torch_kernels_gpu.py holds it against its twin. Here its
computation is emulated window by window in numpy, all block lanes at
once, and held exactly (tolerance 0, an integer codec) against the port's
plain twin `numeric_scan_plain` and the JAX package's `_numeric_scan`:

- staging: blocks of `lanes` adjacent block lanes; tiles of `stage`
  positions x `lanes` lanes of the three planes at a row pitch of
  lanes + 1 words, rows past b and lanes past nb left as garbage; px out
  through a tile of the same pitch, stored row by row;
- a window of `win` positions of one lane (one a thread): each position's
  map (byte mask and value), the anchors (the window's INDEX positions),
  the segmented inclusive scan of the maps by doubling steps;
- each INDEX's writer, the last earlier live non-INDEX position of its
  slot (a match of w), else the lane's slot table; the fixpoint rounds
  from the table's values until nothing changes, counted;
- each slot's last live writer into the table, the window's last px
  carried on, and the last lane's exit state.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from numeric_scan_cases import (DEEP, all_index_planes, deep_chain_planes,
                                random_planes)
from qoi_tpu.models import decode_v3 as jd3
from qoi_tpu_torch.kernels import numeric_scan as tns
from scan_cases import body_of
from test_torch_numeric_scan import (_SEED65, CASES, M, _jax_pass3,
                                     _random_entry)
from torch_testutil import as_u32

_FULL = 0xFFFFFFFF
_CLS_ADD, _CLS_RGB, _CLS_RGBA, _CLS_INDEX = 1, 2, 3, 4
#: the kernel's shape: 32-position windows, 8 lanes a block, 64-position
#: tiles
KERNEL = dict(win=32, lanes=8, stage=64)

_jax_scan = jax.jit(jd3._numeric_scan, static_argnums=(4,))


def _vadd4(a, b):
    return sum((((a >> s) & 0xFF) + ((b >> s) & 0xFF) & 0xFF) << s
               for s in (0, 8, 16, 24))


def _apply(m, v, x):
    """The per-channel map (byte mask m: set to v; else add v mod 256)."""
    return (v & m) | (_vadd4(x, v) & ~m & _FULL)


def _top_bit(mask, width):
    """The highest set bit of each mask, -1 where none (31 - __clz)."""
    top = np.full(mask.shape, -1, np.int64)
    for k in range(width):
        top = np.where((mask >> k) & 1, k, top)
    return top


def _ballot(x):
    """(nb, win) bool -> (nb,) lane masks."""
    return (x.astype(np.int64) << np.arange(x.shape[1])).sum(axis=1)


def scan_by_design(meta, d32, lit32, entry, win=32, lanes=8, stage=64,
                   stats=None):
    """The kernel's computation: (px (b, nb), exit65 (65,)) as u32 values.
    `stats`, a dict, gets the fixpoint rounds of every window as
    stats["rounds"][window] = (nb,) counts."""
    u = lambda a: np.asarray(a).astype(np.int64) & _FULL
    meta, d32, lit32, entry = map(u, (meta, d32, lit32, entry))
    b, nb = meta.shape
    assert stage % win == 0 and win <= 32
    pitch = lanes + 1
    nblk, ntile = -(-nb // lanes), -(-b // stage)
    rng = np.random.default_rng(0)
    lane = np.arange(win)
    lt, le = (1 << lane) - 1, (2 << lane) - 1
    n = np.arange(nb)
    carry = entry[0].copy()
    tab = entry[1:].T.copy()                         # (nb, 64)
    px_out = np.full((b, nb), -1, np.int64)
    rounds = []
    for t in range(ntile):
        i0 = t * stage
        # the ring slot: garbage where nothing is copied
        tiles = rng.integers(0, 1 << 32, (3, stage, nblk, pitch))
        rows = min(stage, b - i0)
        for p, plane in enumerate((meta, d32, lit32)):
            full = np.zeros((rows, nblk * lanes), np.int64)
            full[:, :nb] = plane[i0: i0 + rows]
            view = tiles[p, :rows, :, :lanes]
            keep = np.arange(nblk * lanes).reshape(nblk, lanes) < nb
            view[:] = np.where(keep, full.reshape(rows, nblk, lanes), view)
        # block lane n is warp n % lanes of block n // lanes: its column
        col = tiles[:, :, n // lanes, n % lanes]      # (3, stage, nb)
        tout = np.full((stage, nb), -1, np.int64)
        for j in range(stage // win):
            r = j * win + lane
            if i0 + j * win >= b:
                break
            inside = (i0 + r < b)[None, :]
            mt = np.where(inside, col[0, r].T, 0)     # (nb, win)
            d, lv = col[1, r].T, col[2, r].T
            cls, w = mt & 7, (mt >> 3) & 63
            live, is_idx = cls != 0, cls == _CLS_INDEX
            m = np.where(cls == _CLS_RGBA, _FULL,
                         np.where(cls == _CLS_RGB, 0x00FFFFFF, 0))
            v = np.where(cls == _CLS_ADD, d,
                np.where(cls == _CLS_RGB, lv & 0x00FFFFFF,
                np.where(cls == _CLS_RGBA, lv, 0)))
            idx, livem = _ballot(is_idx), _ballot(live)
            hb = _top_bit(idx[:, None] & le, win)
            s = 1
            while s < win:                   # shuffles read old values
                lm = np.zeros_like(m)
                lvv = np.zeros_like(v)
                lm[:, s:], lvv[:, s:] = m[:, :-s], v[:, :-s]
                take = (lane >= s) & (hb <= lane - s)
                v = np.where(take, _apply(m, v, lvv), v)
                m = np.where(take, m | lm, m)
                s <<= 1
            # __match_any_sync(w) among the live lanes
            same = _ballot_rows(w[:, :, None] == w[:, None, :]) \
                & livem[:, None]
            wr = same & ~idx[:, None] & lt
            dep = is_idx & (wr != 0)
            src = np.where(dep, _top_bit(wr, win), lane)
            val = np.where(is_idx, tab[n[:, None], w], 0)

            def px_of(val):
                head = np.take_along_axis(val, hb & (win - 1), axis=1)
                return _apply(m, v, np.where(hb >= 0, head, carry[:, None]))

            px = px_of(val)
            going = dep.any(axis=1)
            count = np.zeros(nb, np.int64)
            while going.any():
                got = np.take_along_axis(px, src, axis=1)
                nv = np.where(dep, got, val)
                changed = (nv != val).any(axis=1)
                count += going
                going &= changed
                val = np.where(going[:, None], nv, val)
                px = np.where(going[:, None], px_of(val), px)
            rounds.append(count)
            last = live & ((same & ~le) == 0)
            nn, kk = np.nonzero(last)
            tab[nn, w[nn, kk]] = px[nn, kk]
            carry = px[:, win - 1].copy()
            tout[r] = px.T
        px_out[i0: i0 + rows] = tout[:rows]
    if stats is not None:
        stats["rounds"] = rounds
    return px_out, np.concatenate([carry[-1:], tab[-1]])


def _ballot_rows(eq):
    """(nb, win, win) bool -> (nb, win) masks over the last axis."""
    return (eq.astype(np.int64) << np.arange(eq.shape[2])).sum(axis=2)


def _check(planes, stats=None, **shape):
    """The emulation against the twin and JAX's scan on the same planes."""
    meta, d32, lit32, entry = planes
    got = scan_by_design(meta, d32, lit32, entry, stats=stats,
                         **(shape or KERNEL))
    twin = tns.numeric_scan_plain(*(torch.tensor(a.view(np.int32))
                                    for a in planes))
    want = _jax_scan(*(jnp.asarray(a.view(np.uint32)) for a in planes),
                     meta.shape[1])
    for g, tw, jw in zip(got, twin, want):
        np.testing.assert_array_equal(g, as_u32(tw))
        np.testing.assert_array_equal(g, as_u32(jw))


@pytest.fixture(scope="module")
def stream_planes():
    """The six streams' pass-3 inputs from the JAX passes 1 and 2, from
    the seed entry state and from a random one."""
    out = {}
    for name, make in CASES.items():
        pad = np.zeros(M, np.uint8)
        raw = np.frombuffer(body_of(make()), np.uint8)
        pad[: len(raw)] = raw
        for entry, e65 in (("seed", _SEED65), ("random", _random_entry(5))):
            meta, d32p, lit32p, ent, _, _ = _jax_pass3(
                jnp.asarray(pad), jnp.int32(len(raw) - 8), jnp.asarray(e65))
            out[name, entry] = tuple(np.asarray(a) for a in
                                     (meta, d32p, lit32p, ent))
    return out


@pytest.mark.parametrize("entry", ["seed", "random"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_design_on_streams(stream_planes, case, entry):
    """The six streams of tests/test_torch_numeric_scan.py (b = 2048,
    nb = 32) at the kernel's shape. Real streams take few rounds: most
    windows none, 4 at most in these six."""
    stats = {}
    _check(stream_planes[case, entry], stats)
    assert max(int(c.max()) for c in stats["rounds"]) <= 8


@pytest.mark.parametrize("win,lanes,stage", [(16, 8, 64), (32, 16, 32),
                                             (8, 3, 24)])
def test_design_shapes_on_a_stream(stream_planes, win, lanes, stage):
    """Other window sizes, lanes a block and tile heights give the same
    result: none of them is part of what is computed."""
    _check(stream_planes["mixed", "random"], win=win, lanes=lanes,
           stage=stage)


@pytest.mark.parametrize("b,nb", [(16, 7), (48, 33), (2048, 13)])
def test_design_random_planes(b, nb):
    """cls 0..7 on random slots with random r6 bits; b = 16 is under a
    window, b = 48 a ragged last window; nb not a multiple of the block's
    lanes."""
    _check(random_planes(b, nb, b + nb))


@pytest.mark.parametrize("b,nb", [(48, 9), (2048, 5)])
def test_design_all_index(b, nb):
    """Every position an INDEX: no writer in any window, no round; each
    lane replays its entry table."""
    stats = {}
    _check(all_index_planes(b, nb, b * nb), stats)
    assert all(not c.any() for c in stats["rounds"])


@pytest.mark.parametrize("b,nb", [(64, 9), (2048, 3)])
def test_design_deep_chain(b, nb):
    """A window holding a chain of DEEP INDEX steps, each hanging on the
    one before through an ADD writer: DEEP + 1 rounds in that window of
    every lane."""
    stats = {}
    _check(deep_chain_planes(b, nb, 7), stats)
    assert stats["rounds"][0].tolist() == [DEEP + 1] * nb


@pytest.mark.parametrize("lanes", [8, 16])
def test_tile_pitch_column_reads_use_every_bank(lanes):
    """A warp reads its lane's column of 32 rows (one a thread) from a
    tile of pitch lanes + 1 words: 32 distinct banks, for every warp and
    both windows of a 64-row tile."""
    pitch = lanes + 1
    for wp in range(lanes):
        for j in range(2):
            banks = ((j * 32 + np.arange(32)) * pitch + wp) % 32
            assert len(set(banks.tolist())) == 32
