"""The encode main path's word-form staging (`encode_stage_words`, kernel
`qoi_encode_stage_words` of csrc/encode_stage.cu) and the pack encode's
byte-plane staging (`encode_stage_planes`, kernel
`qoi_encode_stage_planes`, the same design) on the CPU.

The kernel runs only on the card, where tests/test_torch_kernels_gpu.py
holds it against its twin. Here, exactly (tolerance 0, an integer codec),
against the JAX package's jitted `encode_stage_chunks(form="words")`,
every record and every field of the outgoing carry:

- the twin, `encode_stage_words_plain` (and the wrapper's CPU route), on
  small frames of the 4K classes and on the carry cases below;
- a model of the kernel's design (csrc/encode_stage.cu's tile_kernel):
  the wrapper's own carry in, tiles of 32 warps of lanes of four
  consecutive pixels (the tile's shape a parameter, so that many small
  tiles can interleave) as coroutines that take tickets in order and run
  in a seeded interleaving, each lane's literal bits, keys and key bytes,
  per warp and slot the writer lanes, each warp's last write of a slot
  and per slot the warps that wrote it, status words (unpublished 0,
  pass, final with a written bit) read back by groups of 4 lanes, the
  incoming carry as a virtual tile before tile 0, the run phase walked
  in registers, the table replay's four steps (the lane's own pixels,
  the warp's lanes, an earlier warp, the carry) counted, the outgoing
  carry from the last tile's inclusive prefix (read through the
  wrapper's `_carry_out`); at the tile's edges (N = 4095, 4096, 4097, three tiles
  and a ragged fourth) and with a slot written only in an earlier warp;
- three tiles chained through the carry against the whole frame;
- the readers of `EncodedWords`, which take the kernel's int32 bit
  patterns and the plain code's int64 alike;
- the planes form of the same model (each lane's bytes of each plane
  stored as 4-byte pieces where N is a multiple of 4, else byte by
  byte; an eq position's run byte left in plane 0) against JAX's
  `encode_stage_chunks(form="bytes")` at N = 1000, 1025, 4096, 4100 and
  3 * 4096 + 1000, and the pack's readers of the planes' lens, which
  take int32 and int64 alike.
"""
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from qoi_tpu.models import pipeline as jpipe
from qoi_tpu.utils import testimages
from qoi_tpu_torch import format as fmt
from qoi_tpu_torch.kernels import encode_stage as kstage
from qoi_tpu_torch.models import pipeline as tpipe
from qoi_tpu_torch.ops import compact
from torch_testutil import as_u32, to_torch

_SEED = np.array(fmt.SEED_PIXEL, np.uint8)
_M32 = 0xFFFFFFFF


@functools.lru_cache(maxsize=None)
def _jax_stage(has_n_valid: bool, has_last: bool, form: str = "words"):
    """The JAX staging, jitted, with every carry argument given traced."""
    def f(px4, n_valid, prev, run, tbl, wr, last):
        return jpipe.encode_stage_chunks(
            px4, n_valid if has_n_valid else None, prev_in=prev, run_in=run,
            table_in=(tbl, wr), contains_last=last if has_last else None,
            form=form)
    return jax.jit(f)


def _jax_args(px4, n_valid=None, prev=None, run=None, tbl=None, wr=None,
              last=None):
    return (jnp.asarray(px4), jnp.int32(0 if n_valid is None else n_valid),
            jnp.asarray(_SEED if prev is None else prev),
            jnp.int32(0 if run is None else run),
            jnp.asarray(np.zeros(64, np.uint32) if tbl is None else tbl),
            jnp.asarray(np.zeros(64, bool) if wr is None else wr),
            jnp.bool_(bool(last)))


def _jax_planes(px4, n_valid=None, last=None, **kw):
    """numpy (staging (6, N), lens, prev_px, run, table, written) of the
    JAX function's bytes form."""
    out = _jax_stage(n_valid is not None, last is not None, "bytes")(
        *_jax_args(px4, n_valid, last=last, **kw))
    return tuple(np.asarray(x) for x in (out.staging, out.lens, *out.carry))


def _jax_words(px4, n_valid=None, prev=None, run=None, tbl=None, wr=None,
               last=None):
    """numpy (lo, hi, lens, prev_px, run, table, written) of the JAX
    function; prev, run, tbl and wr None take its defaults' values."""
    out = _jax_stage(n_valid is not None, last is not None)(
        jnp.asarray(px4), jnp.int32(0 if n_valid is None else n_valid),
        jnp.asarray(_SEED if prev is None else prev),
        jnp.int32(0 if run is None else run),
        jnp.asarray(np.zeros(64, np.uint32) if tbl is None else tbl),
        jnp.asarray(np.zeros(64, bool) if wr is None else wr),
        jnp.bool_(bool(last)))
    return tuple(np.asarray(x) for x in (out.lo, out.hi, out.lens,
                                         *out.carry))


def _port_kwargs(prev=None, run=None, tbl=None, wr=None, last=None):
    return dict(prev_in=None if prev is None else to_torch(prev),
                run_in=run,
                table_in=None if tbl is None else (
                    to_torch(tbl.astype(np.int64)), to_torch(wr)),
                contains_last=last)


def _fields(ch):
    return (ch.lo, ch.hi, ch.lens, *ch.carry)


def _assert_equal(got, want):
    names = ("lo", "hi", "lens", "prev_px", "run", "table", "written")
    for name, g, w in zip(names, got, want):
        np.testing.assert_array_equal(as_u32(g), as_u32(w), err_msg=name)


# ------------------------------------------------------------------ cases

def _pad(img, cap=None):
    """(N, 4) uint8 of an image (alpha 255 for RGB), padded to `cap`
    pixels (default: the facade's bucket), and the valid count."""
    h, w, ch = img.shape
    px4 = tpipe.force_rgba(img, fmt.StreamDesc(w, h, ch))
    cap = tpipe.bucket_size(len(px4)) if cap is None else cap
    out = np.zeros((cap, 4), np.uint8)
    out[: len(px4)] = px4
    return out, len(px4)


def _table(seed, frac):
    rng = np.random.default_rng(seed)
    tbl = rng.integers(0, 1 << 32, 64, dtype=np.uint64).astype(np.uint32)
    return tbl, rng.random(64) < frac


def _from_table(tbl, wr, n, seed):
    """n pixels drawn from the written entries of a table, so that the
    first reads of their slots hit the incoming table, mixed with runs."""
    rng = np.random.default_rng(seed)
    vals = tbl[wr].view(np.uint8).reshape(-1, 4)
    px = vals[rng.integers(0, len(vals), n)]
    px[rng.random(n) < 0.4] = 0
    px[n // 2: n // 2 + 90] = px[n // 2]     # a run across 62
    return px


def _runs(n, first, seed):
    """n pixels opening with a run of `first` (which then equals prev_in
    (12, 200, 7, 255)), then a mixed tail ending in a run."""
    rng = np.random.default_rng(seed)
    px = rng.integers(0, 3, (n, 4)).astype(np.uint8) * 60
    px[:, 3] = 255
    px[:first] = (12, 200, 7, 255)
    px[-150:] = px[-150]
    return px


_PREV = np.array([12, 200, 7, 255], np.uint8)


def _case(name):
    """(px4, n_valid, carry kwargs) of one named case."""
    mixed = lambda w, h, s=3: testimages.mixed(w, h, 4, seed=s)
    if name == "n256":
        return _pad(mixed(16, 16)) + ({},)
    if name == "n1000":
        return _pad(mixed(40, 25), 1000) + ({},)
    if name == "n1024":
        return _pad(mixed(32, 32)) + ({},)
    if name == "n1025":
        return _pad(mixed(41, 25), 1025) + ({},)
    if name == "n_valid_below_n":
        return _pad(mixed(30, 30), 1025) + ({},)
    if name in ("run_in_0", "run_in_1", "run_in_61"):
        run = int(name.rsplit("_", 1)[1])
        tbl, wr = _table(4, 0.5)
        return (_runs(1025, 70, 6), 1025,
                dict(prev=_PREV, run=run, tbl=tbl, wr=wr, last=False))
    if name == "run_in_61_literal_first":
        px = _runs(1025, 0, 6)
        px[0] = (1, 2, 3, 255)
        return px, 1025, dict(prev=_PREV, run=61, last=True)
    if name == "not_last":
        px, n = _pad(mixed(40, 25, 4), 1000)
        px[700:n] = px[700]
        return px, n, dict(last=False)
    if name == "table_in_garbage":
        tbl, wr = _table(9, 0.6)
        return (_from_table(tbl, wr, 2100, 2), 2050,
                dict(prev=_PREV, run=17, tbl=tbl, wr=wr, last=False))
    if name == "zero_rgba_first":
        px, n = _pad(mixed(32, 40, 5), 1300)
        px[:40] = 0                    # slot 0 written with the value 0,
        px[900:905] = 0                # hit later, and written last
        px[n - 30:n] = 0
        return px, n, dict(last=False)
    if name == "one_colour_blocks":
        tbl, wr = _table(11, 0.3)
        px = np.tile(np.array([[9, 9, 9, 255]], np.uint8), (4100, 1))
        return px, 4100, dict(prev=_PREV, run=30, tbl=tbl, wr=wr, last=False)
    if name == "n_valid_none_not_last":
        return _pad(mixed(32, 32, 6))[:1] + (None, dict(last=False))
    if name == "n_valid_zero":
        tbl, wr = _table(12, 0.5)
        return (_pad(mixed(16, 16))[0], 0,
                dict(prev=_PREV, run=44, tbl=tbl, wr=wr, last=False))
    if name == "mixed_96x64":
        return _pad(mixed(96, 64)) + ({},)
    # the kernel's 4096-pixel tile: one short, whole, one over; three
    # tiles and a ragged fourth with carries in and n_valid < N
    if name == "tile_minus_1":
        return _pad(mixed(63, 65, 8), 4095) + ({},)
    if name == "tile":
        return _pad(mixed(64, 64, 9), 4096) + (dict(last=False),)
    if name == "tile_plus_1":
        tbl, wr = _table(13, 0.5)
        return _pad(mixed(17, 241, 10), 4097) + (
            dict(prev=_PREV, run=5, tbl=tbl, wr=wr, last=True),)
    if name == "three_tiles_ragged":
        tbl, wr = _table(14, 0.7)
        px, _ = _pad(mixed(88, 151, 11), 3 * 4096 + 1000)
        px[4000:4200] = px[4000]          # a run across a tile's end
        return px, 3 * 4096 + 990, dict(prev=_PREV, run=61, tbl=tbl, wr=wr,
                                         last=False)
    if name == "earlier_warp_slot":
        return _earlier_warp_slot(), 4096, dict(last=True)
    raise KeyError(name)


def _earlier_warp_slot():
    """(4096, 4) pixels alternating two colours, each a literal hitting
    the table, and a third colour whose slot nobody else writes at
    positions 10 (warp 0) and 1287 (warp 10, lane 1, its last pixel):
    1287's last earlier writer is in an earlier warp of the tile."""
    a, b = (10, 20, 30, 255), (200, 100, 50, 255)
    c = (1, 2, 3, 255)
    packed = lambda x: int(np.array(x, np.uint8).view(np.uint32)[0])
    assert len({_hash(packed(x)) for x in (a, b, c)}) == 3
    px = np.array([a, b] * 2048, np.uint8)
    px[[10, 1287]] = c
    return px


CASES = ["n256", "n1000", "n1024", "n1025", "n_valid_below_n", "run_in_0",
         "run_in_1", "run_in_61", "run_in_61_literal_first", "not_last",
         "table_in_garbage", "zero_rgba_first", "one_colour_blocks",
         "n_valid_none_not_last", "n_valid_zero", "mixed_96x64",
         "tile_minus_1", "tile", "tile_plus_1", "three_tiles_ragged",
         "earlier_warp_slot"]

#: small frames of the 4K main path's classes, padded to the facade's
#: bucket
FRAMES = {
    "mixed_96x64": lambda: testimages.mixed(96, 64, 4, seed=3),
    "photo_160x96": lambda: testimages.photo(160, 96, 4, seed=3),
    "one_colour_96x64": lambda: testimages.flat(96, 64, 4),
    "photo_rgb_160x96": lambda: testimages.photo(160, 96, 3, seed=4),
}

_WANT = {}


def _want(key, px4, n_valid, kw):
    if key not in _WANT:
        _WANT[key] = _jax_words(px4, n_valid, **kw)
    return _WANT[key]


# ------------------------------------------------------ the kernel design

_COLS, _GROUP = 65, 4
_PASS, _FINAL = 1, 2
#: the kernel's tile: 32 warps of lanes of 4 consecutive pixels (512
#: threads, each running two lanes)
_PX, _WARPS = 4, 32


def _hash(p):
    return ((p & 0xFF) * 3 + ((p >> 8) & 0xFF) * 5 + ((p >> 16) & 0xFF) * 7
            + (p >> 24) * 11) & 63


def _top(m):
    return m.bit_length() - 1


def _vsub4(a, b):
    return sum((((a >> s) & 0xFF) - ((b >> s) & 0xFF) & 0xFF) << s
               for s in (0, 8, 16, 24))


def _vadd4(a, b):
    return sum((((a >> s) & 0xFF) + ((b >> s) & 0xFF) & 0xFF) << s
               for s in (0, 8, 16, 24))


def _word(tag, written, value):
    """A status word: (tag, written bit, u32 value); 0 is unpublished."""
    return (tag, bool(written), value & _M32)


def _record(pk, prev, key, before, eq, flush, emits_run, run_m, prev_m,
            keep_run):
    """The kernel's `record`: (lo, hi, len) of one pixel, 0 past len but
    for an eq position's run byte where keep_run (the planes)."""
    hit = before == pk
    d = _vsub4(pk, prev)
    alpha_same = d >> 24 == 0
    dd = _vadd4(d, 0x00020202)
    is_diff = alpha_same and dd & 0x00FCFCFC == 0
    dl = _vadd4(_vsub4(d, ((d >> 8) & 0xFF) * 0x01010101), 0x00080008)
    gl = ((d >> 8) + 32) & 0xFF
    is_luma = (alpha_same and not is_diff and gl < 64
               and dl & 0x00F000F0 == 0)
    is_rgb = alpha_same and not is_diff and not is_luma
    small = hit or is_diff
    own0 = (key if hit else
            0x40 | (dd & 3) << 4 | ((dd >> 8) & 3) << 2 | ((dd >> 16) & 3)
            if is_diff else
            0x80 | gl if is_luma else 0xFE if is_rgb else 0xFF)
    own1 = (0 if small else (dl & 0xF) << 4 | ((dl >> 16) & 0xF) if is_luma
            else pk)
    olo = (own0 | own1 << 8) & _M32
    ohi = pk >> 24 if not (small or is_luma or is_rgb) else 0
    own_len = 1 if small else 2 if is_luma else 4 if is_rgb else 5
    if eq:
        return (0xC0 | run_m if emits_run or keep_run else 0), 0, \
            int(emits_run)
    if flush:
        return ((0xC0 | prev_m) | olo << 8) & _M32, ohi << 8 | olo >> 24, \
            own_len + 1
    return olo, ohi, own_len


def _last_key_byte(kw, key):
    """The kernel's `last_key_byte`: the last of a thread's key bytes
    (eight in the kernel) equal to key."""
    return max(j for j in range(len(kw)) if kw[j] == key)


def _words_by_design(px4, carry, seed=0, px=_PX, warps=_WARPS):
    """csrc/encode_stage.cu's tile_kernel (words and planes forms) in
    Python: px4 (N, 4) uint8 and the wrapper's carry in (`_carry_args`:
    header, from_dev, carry_in) -> (lo, hi, lens (N,) int64 u32, carry_out
    (66,) int64, written_out (64,) uint8, counts, planes (6, N) uint8).
    Tiles are 32 * warps lanes of `px` consecutive pixels (the kernel's 32
    warps of 4; a thread of the kernel runs two lanes, which changes no
    result); they start in ticket order, at most 6 at a time, and a
    seeded generator interleaves their steps. The counts: the look-back's
    waits and slides, the planes' px-byte and byte stores a lane, and
    where the literals found the last earlier writer of their slots
    (own, lane, warp, carry; "steps": each literal's)."""
    hdr, from_dev, cin = carry
    cin = [0] * 133 if cin is None else [int(x) for x in cin]
    hdr = [cin[k] if from_dev >> k & 1 else hdr[k] for k in range(5)]
    if not from_dev >> 5 & 1:
        cin[5:] = [0] * 128
    pxs = [int(x) for x in px4.view(np.uint32).reshape(-1)]
    n = len(pxs)
    nv = min(max(hdr[0], 0), n)
    cn = min(max(hdr[1], 0), n)
    run_in, seed_px, last_flag = hdr[2], hdr[3] & _M32, hdr[4]
    last_pos = nv - 1 if last_flag else -1
    nthr = 32 * warps
    tile_px = nthr * px
    # the virtual tile before tile 0: final words of the incoming carry
    none = [_word(_FINAL, cin[69 + c] != 0,
                  cin[5 + c] if cin[69 + c] != 0 else 0) for c in range(64)]
    none.append(_word(_FINAL, False, -1 - run_in))
    ntile = -(-n // tile_px)
    status = {}
    lo, hi, lens = [0] * n, [0] * n, [0] * n
    cout, wr_out = [0] * 66, [0] * 64
    planes = np.full(6 * n, -1, np.int64)
    rng = np.random.default_rng(seed)
    seen = dict.fromkeys(("wait", "slide", "vec", "byte", "own", "lane",
                          "warp", "carry"), 0)
    steps = seen["steps"] = {}     # each literal's replay step

    def tile(blk):
        base = blk * tile_px
        # 1. each thread's pixels (0 past N), the pixel before them (the
        # lane below's last, or a load for lane 0), its literal bits, keys
        # and key bytes (0xFF for eq); per warp and slot the writer lanes
        spx = [pxs[g] if g < n else 0 for g in range(base, base + tile_px)]
        th = []
        for t in range(nthr):
            g0 = base + t * px
            p = spx[t * px: (t + 1) * px]
            if t % 32:
                before_t = th[t - 1]["p"][-1]
            else:
                before_t = (seed_px if g0 == 0
                            else pxs[g0 - 1] if g0 <= n else 0)
            prev = [before_t] + p[:-1]
            lits = sum(1 << k for k in range(px)
                       if not (p[k] == prev[k] or g0 + k >= nv))
            keys = [_hash(x) for x in p]
            kw = [keys[k] if lits >> k & 1 else 0xFF for k in range(px)]
            th.append(dict(p=p, before=before_t, lits=lits, keys=keys,
                           kw=kw, last=g0 + _top(lits) if lits else None))
        wm = [[0] * 64 for _ in range(warps)]
        for t, d in enumerate(th):
            for k in range(px):
                if d["lits"] >> k & 1:
                    wm[t // 32][d["keys"][k]] |= 1 << (t % 32)
        # per warp: its last write of each slot; per slot the warps that
        # wrote it; a warp's last literal, the warps with a literal
        wagg = [[None] * 64 for _ in range(warps)]
        tmask = [0] * 64
        for w in range(warps):
            for s in range(64):
                if wm[w][s]:
                    t = w * 32 + _top(wm[w][s])
                    wagg[w][s] = spx[t * px + _last_key_byte(th[t]["kw"], s)]
                    tmask[s] |= 1 << w
        wl = [sum(1 << ln for ln in range(32) if th[w * 32 + ln]["lits"])
              for w in range(warps)]
        wlast = [th[w * 32 + _top(wl[w])]["last"] if wl[w] else None
                 for w in range(warps)]
        litmask = sum(1 << w for w in range(warps) if wl[w])
        yield
        # 2. publish each column's aggregate at once
        own, mask = [], []
        for c in range(_COLS):
            m = tmask[c] if c < 64 else litmask
            agg = 0
            if m:
                agg = wagg[_top(m)][c] if c < 64 else wlast[_top(m)]
            own.append(_word(_FINAL, True, agg))
            mask.append(m)
            status[blk, c] = (own[c] if m else none[c] if blk == 0
                              else _word(_PASS, False, 0))
        yield
        # ... then look back: a group of 4 lanes reads tiles hi .. hi - 3;
        # the nearest word that is not a pass word is the carry, or is
        # waited for while unpublished
        carry = list(none)
        for c in range(_COLS) if blk else ():
            hi_ = blk - 1
            while True:
                ws = [status.get((j, c), 0) if j >= 0 else none[c]
                      for j in range(hi_, hi_ - _GROUP, -1)]
                stops = [w for w in ws if w == 0 or w[0] != _PASS]
                if not stops:
                    hi_ -= _GROUP
                    seen["slide"] += 1
                    yield
                    continue
                if stops[0] == 0:
                    seen["wait"] += 1
                    yield
                    continue
                carry[c] = stops[0]
                break
            if not mask[c]:
                status[blk, c] = carry[c]
            if rng.random() < 0.2:
                yield
        if blk == ntile - 1:
            # the outgoing carry: this tile's inclusive prefix
            for c in range(64):
                inc = own[c] if mask[c] else carry[c]
                cout[2 + c], wr_out[c] = inc[2], int(inc[1])
            last_lit = own[64] if mask[64] else carry[64]
            last_lit = last_lit[2] - (1 << 32) * (last_lit[2] >> 31)
            cout[1] = 0 if last_flag == 1 else (cn - 1 - last_lit) % 62
            cout[0] = pxs[cn - 1] if cn > 0 else seed_px
        # 3. each thread's pixels against their predecessors
        lit_in = carry[64][2] - (1 << 32) * (carry[64][2] >> 31)
        inval = [carry[c][2] for c in range(64)]
        for t, d in enumerate(th):
            w, lane, g0 = t // 32, t % 32, base + t * px
            if g0 >= n:
                continue
            # the last literal before the thread: the lane below's, an
            # earlier warp's, or the carry
            lb = wl[w] & ((1 << lane) - 1)
            rl = litmask & ((1 << w) - 1)
            lp0 = (th[w * 32 + _top(lb)]["last"] if lb
                   else wlast[_top(rl)] if rl else lit_in)
            q, prev_lit = (g0 - 1 - lp0) % 62, lp0 == g0 - 1
            assert g0 - 1 - lp0 >= 0
            p, keys, lits = d["p"], d["keys"], d["lits"]
            recs = []
            for k in range(px):
                gid, lit = g0 + k, bool(lits >> k & 1)
                qn = 0 if lit else (0 if q == 61 else q + 1)
                run_m = qn - 1 if qn else 61
                prev_m = q - 1 if q else 61
                emits_run = not lit and gid < nv and (qn == 0
                                                      or gid == last_pos)
                flush = lit and not prev_lit and q != 0
                q, prev_lit = qn, lit
                before = 0
                if lit:
                    own_j = [j for j in range(k)
                             if lits >> j & 1 and keys[j] == keys[k]]
                    lw = wm[w][keys[k]] & ((1 << lane) - 1)
                    rw = tmask[keys[k]] & ((1 << w) - 1)
                    if own_j:
                        before, step = p[own_j[-1]], "own"
                    elif lw:
                        l = w * 32 + _top(lw)
                        before = spx[l * px + _last_key_byte(th[l]["kw"],
                                                             keys[k])]
                        step = "lane"
                    elif rw:
                        before, step = wagg[_top(rw)][keys[k]], "warp"
                    else:
                        before, step = inval[keys[k]], "carry"
                    seen[step] += 1
                    steps[gid] = step
                prev = p[k - 1] if k else d["before"]
                lo_, hi_, ln_ = _record(p[k], prev, keys[k], before,
                                        not lit, flush, emits_run, run_m,
                                        prev_m, False)
                plo, phi, _ = _record(p[k], prev, keys[k], before, not lit,
                                      flush, emits_run, run_m, prev_m, True)
                recs.append((lo_ | hi_ << 32, ln_, plo | phi << 32))
            # the stores: 16-byte pieces of four pixels where the thread is
            # whole, else pixel by pixel up to N
            for k, (st, ln_, _) in enumerate(recs):
                if g0 + k < n:
                    lo[g0 + k], hi[g0 + k] = st & _M32, st >> 32
                    lens[g0 + k] = ln_
            # the planes: `px` bytes a plane where N is a multiple of px and
            # the thread whole, else byte by byte up to N
            if g0 + px <= n and n % px == 0:
                for b in range(6):
                    row = b * n + g0
                    assert row % px == 0 and row + px <= (b + 1) * n
                    planes[row: row + px] = [(pst >> 8 * b) & 0xFF
                                             for _, _, pst in recs]
                seen["vec"] += 1
            else:
                for b in range(6):
                    for k, (_, _, pst) in enumerate(recs):
                        if g0 + k < n:
                            planes[b * n + g0 + k] = (pst >> 8 * b) & 0xFF
                seen["byte"] += 1

    pending, running = list(range(ntile)), []
    while pending or running:
        if pending and len(running) < 6 and (not running
                                             or rng.random() < 0.3):
            running.append(tile(pending.pop(0)))
            continue
        co = running[int(rng.integers(len(running)))]
        try:
            next(co)
        except StopIteration:
            running.remove(co)
    assert (planes >= 0).all(), "a plane byte was never stored"
    return (np.array(lo), np.array(hi), np.array(lens), np.array(cout),
            np.array(wr_out, np.uint8), seen,
            planes.astype(np.uint8).reshape(6, n))


def _carry_of(cout, wr):
    """The model's carry out through the wrapper's `_carry_out`."""
    return kstage._carry_out(torch.from_numpy(cout), torch.from_numpy(wr))


def _model_words(px4, n_valid=None, seed=0, tile=(_PX, _WARPS), **kw):
    """The design model through the wrapper's carry_in and _carry_out:
    (lo, hi, lens, prev_px, run, table, written), and the model's counts;
    `tile` is (pixels a thread, warps a tile)."""
    k = _port_kwargs(**kw)
    carry = kstage._carry_args(px4.shape[0], n_valid, k["prev_in"],
                               k["run_in"], k["table_in"],
                               k["contains_last"], torch.device("cpu"))
    lo, hi, lens, cout, wr, seen, _ = _words_by_design(px4, carry, seed,
                                                       *tile)
    return (lo, hi, lens, *_carry_of(cout, wr)), seen


# ------------------------------------------------------------------ tests

@pytest.mark.parametrize("case", CASES)
def test_twin_matches_jax(case):
    px4, n_valid, kw = _case(case)
    want = _want(case, px4, n_valid, kw)
    got = kstage.encode_stage_words_plain(to_torch(px4), n_valid,
                                          **_port_kwargs(**kw))
    _assert_equal(_fields(got), want)
    # the wrapper takes the twin for a CPU tensor
    _assert_equal(_fields(kstage.encode_stage_words(
        to_torch(px4), n_valid, **_port_kwargs(**kw))), want)


@pytest.mark.parametrize("case", CASES)
def test_design_matches_jax(case):
    px4, n_valid, kw = _case(case)
    got, _ = _model_words(px4, n_valid, seed=len(case), **kw)
    _assert_equal(got, _want(case, px4, n_valid, kw))


@pytest.mark.parametrize("frame", list(FRAMES))
def test_twin_matches_jax_on_frames(frame):
    px4, n = _pad(FRAMES[frame]())
    got = kstage.encode_stage_words_plain(to_torch(px4), n)
    _assert_equal(_fields(got), _want(frame, px4, n, {}))


@pytest.mark.parametrize("case,from_dev", [
    ("run_in_61", 0b111111),              # every field and the table
    ("n_valid_none_not_last", 0b10010)])  # the count and contains_last
def test_design_takes_the_carry_as_tensors(case, from_dev):
    """Every carry argument a tensor (read by the kernel from carry_in,
    marked in from_dev), n_valid and contains_last included."""
    px4, n_valid, kw = _case(case)
    k = _port_kwargs(**kw)
    as_t = lambda x: None if x is None else torch.as_tensor(x)
    args = kstage._carry_args(
        px4.shape[0], as_t(n_valid), k["prev_in"], as_t(k["run_in"]),
        k["table_in"], as_t(k["contains_last"]), torch.device("cpu"))
    assert args[1] == from_dev
    lo, hi, lens, cout, wr, _, _ = _words_by_design(px4, args, 1)
    _assert_equal((lo, hi, lens, *_carry_of(cout, wr)),
                  _want(case, px4, n_valid, kw))


def test_design_interleavings_wait_and_slide():
    """On the one-colour frame every column but the colour's slot walks
    back to the virtual tile: at a small tile (2 warps of 4 pixels a
    thread, 256 pixels; 17 tiles), in some seeded interleavings a group
    waits for an unpublished word, and looks back past 4 tiles."""
    px4, n_valid, kw = _case("one_colour_blocks")
    want = _want("one_colour_blocks", px4, n_valid, kw)
    total = {"wait": 0, "slide": 0}
    for seed in range(3):
        got, seen = _model_words(px4, n_valid, seed=seed, tile=(4, 2), **kw)
        _assert_equal(got, want)
        for k in total:
            total[k] += seen[k]
    assert total["wait"] > 0 and total["slide"] > 0, total


@pytest.mark.parametrize("case,tile", [("mixed_96x64", (4, 2)),
                                       ("three_tiles_ragged", (2, 4)),
                                       ("table_in_garbage", (8, 1))])
def test_design_at_small_tiles(case, tile):
    """The same design at other tile shapes (pixels a thread, warps):
    many tiles in a seeded interleaving, each replay step reached."""
    px4, n_valid, kw = _case(case)
    got, seen = _model_words(px4, n_valid, seed=7, tile=tile, **kw)
    _assert_equal(got, _want(case, px4, n_valid, kw))
    assert min(seen[k] for k in ("own", "lane", "carry")) > 0, seen
    if tile[1] > 1:
        assert seen["warp"] > 0, seen


def test_design_reaches_an_earlier_warp():
    """A slot written only in warp 0 of the tile and read in warp 10 (lane
    1) is found by the warp step -- the earlier warps' slot bitmask and
    that warp's last write -- not by the look-back, and hits."""
    px4, n_valid, kw = _case("earlier_warp_slot")
    got, seen = _model_words(px4, n_valid, **kw)
    want = _want("earlier_warp_slot", px4, n_valid, kw)
    _assert_equal(got, want)
    assert seen["steps"][1287] == "warp"
    # the first writes of the three slots reach the carry; lane 0 of
    # warps 1-31 finds the two colours' slots in the warp before
    assert seen["carry"] == 3 and seen["warp"] == 1 + 31 * 2, seen
    assert as_u32(want[0])[1287] == _hash(
        int(px4[1287].view(np.uint32)[0]))     # an INDEX record: a hit


def test_twin_dtypes():
    """The twin's fields have the kernel's dtypes: lo, hi, lens int32;
    the carry as the plain code's (prev_px uint8, run 0-d int64, table
    int64 u32, written bool)."""
    px4, n_valid, kw = _case("table_in_garbage")
    got = kstage.encode_stage_words_plain(to_torch(px4), n_valid,
                                          **_port_kwargs(**kw))
    assert [x.dtype for x in _fields(got)] == [
        torch.int32, torch.int32, torch.int32, torch.uint8, torch.int64,
        torch.int64, torch.bool]
    assert [tuple(x.shape) for x in got.carry] == [(4,), (), (64,), (64,)]


def _tiles(px4, n, t, stage):
    """Stage n pixels of px4 in tiles of t, each tile's carry into the
    next; returns the concatenated valid records and the last carry."""
    recs, carry = [], {}
    for k in range(-(-n // t)):
        tile = np.zeros((t, 4), np.uint8)
        part = px4[k * t: min(n, (k + 1) * t)]
        tile[: len(part)] = part
        out = stage(tile, len(part), n <= (k + 1) * t, carry)
        recs.append([np.asarray(as_u32(x))[: len(part)] for x in out[:3]])
        prev_px, run, tbl, wr = out[3:]
        carry = dict(prev_in=prev_px, run_in=run, table_in=(tbl, wr))
    return [np.concatenate(r) for r in zip(*recs)], out[3:]


@pytest.mark.parametrize("stage", ["twin", "design"])
def test_three_tiles_chained_equal_the_whole_frame(stage):
    img = testimages.mixed(50, 60, 4, seed=7)
    px4 = tpipe.force_rgba(img, fmt.StreamDesc(50, 60, 4))
    px4[1000:1130] = px4[1000]        # a run across the first tile's end
    n = len(px4)

    def twin(tile, nv, last, carry):
        return _fields(kstage.encode_stage_words(
            to_torch(tile), nv, contains_last=last, **carry))

    def design(tile, nv, last, carry):
        args = kstage._carry_args(len(tile), nv, carry.get("prev_in"),
                                  carry.get("run_in"), carry.get("table_in"),
                                  last, torch.device("cpu"))
        lo, hi, lens, cout, wr, _, _ = _words_by_design(tile, args, nv)
        return (lo, hi, lens, *_carry_of(cout, wr))

    recs, carry = _tiles(px4, n, 1024, {"twin": twin, "design": design}[stage])
    want = _want("chain_whole", px4, n, dict(last=True))
    for name, g, w in zip(("lo", "hi", "lens"), recs, want[:3]):
        np.testing.assert_array_equal(g, as_u32(w), err_msg=name)
    _assert_equal((0, 0, 0, *carry), (0, 0, 0, *want[3:]))


@pytest.mark.parametrize("seg", [0, 512])
def test_words_readers_take_int32_bit_patterns(seg):
    """compact_words6_wordsum and wordsum_events (every reader of
    EncodedWords: the main path, the streamed and tiled encodes,
    kernel_profile) give the same words and events from the kernel's
    int32 fields as from the plain code's int64 ones; the mixed frame's
    RGBA records put bytes >= 0x80 in the high byte of lo."""
    px4, n = _pad(testimages.mixed(48, 40, 4, seed=3))
    wide = tpipe.encode_stage_chunks(to_torch(px4), n)
    narrow = kstage.encode_stage_words_plain(to_torch(px4), n)
    assert wide.lo.dtype == torch.int64 and narrow.lo.dtype == torch.int32
    assert bool((narrow.lo < 0).any())
    cap = px4.shape[0] * 6
    w64, t64 = compact.compact_words6_wordsum(wide.lo, wide.hi, wide.lens,
                                              cap, seg=seg)
    w32, t32 = compact.compact_words6_wordsum(narrow.lo, narrow.hi,
                                              narrow.lens, cap, seg=seg)
    assert int(t64) == int(t32)
    assert torch.equal(w64, w32)
    e64 = compact.wordsum_events(wide.lo, wide.hi, wide.lens, seg)
    e32 = compact.wordsum_events(narrow.lo, narrow.hi, narrow.lens, seg)
    for a, b in zip(e64, e32):
        assert torch.equal(a, b)


def test_wrapper_refuses_bad_shapes():
    with pytest.raises(ValueError, match="N = 0"):
        kstage.encode_stage_words(torch.zeros((0, 4), dtype=torch.uint8))
    with pytest.raises(ValueError, match="want"):
        kstage.encode_stage_words(torch.zeros((8, 3), dtype=torch.uint8))
    for bad in (-1, 9):
        with pytest.raises(ValueError, match="outside"):
            kstage.encode_stage_words(torch.zeros((8, 4), dtype=torch.uint8),
                                      bad)


# ------------------------------------------------------ the planes form

#: cases of the planes form's model: N = 1000 (a ragged tile), 1025
#: (N not a multiple of 4: byte stores), with a carry in and padding past
#: n_valid, 4100 (one colour, a carry in, not the last tile), 4096 (one
#: whole tile, 4-byte stores) and 3 * 4096 + 1000 (four tiles, carries)
PLANE_CASES = ["n1000", "n1025", "n_valid_below_n", "run_in_61",
               "one_colour_blocks", "tile", "three_tiles_ragged"]


@pytest.mark.parametrize("case", PLANE_CASES)
def test_planes_design_matches_jax(case):
    """The model's planes, lens and carry (through the wrapper's
    `_carry_args` and `_carry_out`) equal JAX's bytes form; the twin's
    too."""
    px4, n_valid, kw = _case(case)
    want = _jax_planes(px4, n_valid, **kw)
    k = _port_kwargs(**kw)
    args = kstage._carry_args(px4.shape[0], n_valid, k["prev_in"],
                              k["run_in"], k["table_in"],
                              k["contains_last"], torch.device("cpu"))
    _, _, lens, cout, wr, seen, planes = _words_by_design(px4, args,
                                                          len(case))
    got = (planes, lens, *_carry_of(cout, wr))
    names = ("staging", "lens", "prev_px", "run", "table", "written")
    for name, g, w in zip(names, got, want):
        np.testing.assert_array_equal(as_u32(g), as_u32(w), err_msg=name)
    twin = kstage.encode_stage_planes(to_torch(px4), n_valid, **k)
    assert twin.lens.dtype == torch.int32
    for name, g, w in zip(names, (twin.staging, twin.lens, *twin.carry),
                          want):
        np.testing.assert_array_equal(as_u32(g), as_u32(w), err_msg=name)
    # every eq position keeps a run byte in plane 0, emitted or not
    assert (planes[0][lens == 0] & 0xC0 == 0xC0).all()
    # a lane stores 4 bytes a plane where N is a multiple of 4, else byte
    # by byte
    n = px4.shape[0]
    lanes = -(-n // 4)
    assert (seen["vec"], seen["byte"]) == (
        (lanes, 0) if n % 4 == 0 else (0, lanes)), seen


@pytest.mark.parametrize("densify", ["shift", "sort"])
def test_pack_readers_take_int32_and_int64_lens(densify):
    """densify_records, compact_bytes6_pack and compact_bytes6 give the
    oracle's stream from the planes with the kernel's int32 lens and the
    plain code's int64 ones."""
    from qoi_tpu_torch import oracle
    from qoi_tpu_torch.kernels import pack as kpack

    if not oracle.available():
        pytest.skip("oracle not built")
    img = testimages.mixed(64, 128, 4, seed=3)
    want = oracle.encode(img, fmt.StreamDesc(64, 128, 4))
    body = want[fmt.HEADER_SIZE: -fmt.TRAILER_SIZE]
    px4, n = _pad(img, 8192)
    wide = tpipe.encode_stage_chunks(to_torch(px4), n, form="bytes")
    narrow = kstage.encode_stage_planes_plain(to_torch(px4), n)
    assert wide.lens.dtype == torch.int64
    assert narrow.lens.dtype == torch.int32
    for ch in (wide, narrow):
        off_d, lo_d, hi_d, total = kpack.densify_records(ch.staging, ch.lens)
        buf, tot = kpack.place_records(off_d, lo_d, hi_d, total, 8192 * 6)
        assert bytes(buf[: int(tot)].numpy()) == body
        buf, tot = kpack.compact_bytes6_pack(ch.staging, ch.lens, 8192 * 6,
                                             densify=densify)
        assert bytes(buf[: int(tot)].numpy()) == body
        buf, tot = compact.compact_bytes6(ch.staging, ch.lens, 8192 * 6)
        assert bytes(buf[: int(tot)].numpy()) == body
