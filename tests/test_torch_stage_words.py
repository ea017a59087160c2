"""The encode main path's word-form staging (`encode_stage_words`, kernel
`qoi_encode_stage_words` of csrc/encode_stage.cu) on the CPU.

The kernel runs only on the card, where tests/test_torch_kernels_gpu.py
holds it against its twin. Here, exactly (tolerance 0, an integer codec),
against the JAX package's jitted `encode_stage_chunks(form="words")`,
every record and every field of the outgoing carry:

- the twin, `encode_stage_words_plain` (and the wrapper's CPU route), on
  small frames of the 4K classes and on the carry cases below;
- a model of the kernel's design: the wrapper's own carry in, the
  1024-pixel blocks as coroutines that take tickets in order and run in a
  seeded interleaving, per-row literal and slot-writer bitmasks, status
  words (unpublished 0, pass, final with a written bit) read back by
  groups of 3 lanes, the incoming carry as a virtual block before block
  0, the outgoing carry from the last block's inclusive prefix (read
  through the wrapper's `_carry_out`);
- three tiles chained through the carry against the whole frame;
- the readers of `EncodedWords`, which take the kernel's int32 bit
  patterns and the plain code's int64 alike.
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
def _jax_stage(has_n_valid: bool, has_last: bool):
    """The JAX staging, jitted, with every carry argument given traced."""
    def f(px4, n_valid, prev, run, tbl, wr, last):
        return jpipe.encode_stage_chunks(
            px4, n_valid if has_n_valid else None, prev_in=prev, run_in=run,
            table_in=(tbl, wr), contains_last=last if has_last else None,
            form="words")
    return jax.jit(f)


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
    raise KeyError(name)


CASES = ["n256", "n1000", "n1024", "n1025", "n_valid_below_n", "run_in_0",
         "run_in_1", "run_in_61", "run_in_61_literal_first", "not_last",
         "table_in_garbage", "zero_rgba_first", "one_colour_blocks",
         "n_valid_none_not_last", "n_valid_zero", "mixed_96x64"]

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

_BLOCK, _ROW, _COLS, _GROUP = 1024, 32, 65, 3
_PASS, _FINAL = 1, 2


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


def _words_by_design(px4, carry, seed=0):
    """csrc/encode_stage.cu's words form in Python: px4 (N, 4) uint8 and
    the wrapper's carry in (`_carry_args`: header, from_dev, carry_in) ->
    (lo, hi, lens (N,) int64 u32, carry_out (66,) int64, written_out (64,)
    uint8, the look-back's counts). Blocks start in ticket order, at most
    6 at a time, and a seeded generator interleaves their steps."""
    hdr, from_dev, cin = carry
    cin = [0] * 133 if cin is None else [int(x) for x in cin]
    hdr = [cin[k] if from_dev >> k & 1 else hdr[k] for k in range(5)]
    if not from_dev >> 5 & 1:
        cin[5:] = [0] * 128
    px = [int(x) for x in px4.view(np.uint32).reshape(-1)]
    n = len(px)
    nv = min(max(hdr[0], 0), n)
    cn = min(max(hdr[1], 0), n)
    run_in, seed_px, last_flag = hdr[2], hdr[3] & _M32, hdr[4]
    last_pos = nv - 1 if last_flag else -1
    # the virtual block before block 0: final words of the incoming carry
    none = [_word(_FINAL, cin[69 + c] != 0,
                  cin[5 + c] if cin[69 + c] != 0 else 0) for c in range(64)]
    none.append(_word(_FINAL, False, -1 - run_in))
    nblk = -(-n // _BLOCK)
    status = {}
    lo, hi, lens = [0] * n, [0] * n, [0] * n
    cout, wr_out = [0] * 66, [0] * 64
    rng = np.random.default_rng(seed)
    seen = {"wait": 0, "slide": 0}

    def block(blk):
        base = blk * _BLOCK
        p = [px[g] if g < n else 0 for g in range(base, base + _BLOCK)]
        prev = [seed_px if base == 0 else px[base - 1]] + p[:-1]
        eq = [p[i] == prev[i] or base + i >= nv for i in range(_BLOCK)]
        # 1. per row its literal lanes and per slot the lanes that wrote
        # it; per block the rows that wrote each slot, the rows with a
        # literal
        lrow = [sum(1 << ln for ln in range(_ROW) if not eq[r * _ROW + ln])
                for r in range(_ROW)]
        lmask = [[0] * 64 for _ in range(_ROW)]
        for i in range(_BLOCK):
            if not eq[i]:
                lmask[i // _ROW][_hash(p[i])] |= 1 << (i % _ROW)
        wmask = [sum(1 << r for r in range(_ROW) if lmask[r][c])
                 for c in range(64)]
        litmask = sum(1 << r for r in range(_ROW) if lrow[r])
        yield
        # 2. publish each column's aggregate at once
        own, mask = [], []
        for c in range(_COLS):
            m = wmask[c] if c < 64 else litmask
            agg = 0
            if m:
                r = _top(m)
                agg = (p[r * _ROW + _top(lmask[r][c])] if c < 64
                       else base + r * _ROW + _top(lrow[r]))
            own.append(_word(_FINAL, True, agg))
            mask.append(m)
            status[blk, c] = (own[c] if m else none[c] if blk == 0
                              else _word(_PASS, False, 0))
        yield
        # ... then look back: a group of 3 lanes reads blocks hi .. hi - 2;
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
        if blk == nblk - 1:
            # the outgoing carry: this block's inclusive prefix
            for c in range(64):
                inc = own[c] if mask[c] else carry[c]
                cout[2 + c], wr_out[c] = inc[2], int(inc[1])
            last_lit = own[64] if mask[64] else carry[64]
            last_lit = last_lit[2] - (1 << 32) * (last_lit[2] >> 31)
            cout[1] = 0 if last_flag == 1 else (cn - 1 - last_lit) % 62
            cout[0] = px[cn - 1] if cn > 0 else seed_px
        # 3. every pixel against the last literal before the block
        lit_before = carry[64][2] - (1 << 32) * (carry[64][2] >> 31)
        inval = [carry[c][2] for c in range(64)]
        for i in range(min(_BLOCK, n - base)):
            gid, (r, lane) = base + i, divmod(i, _ROW)
            rl = litmask & ((1 << r) - 1)
            rlit = (base + _top(rl) * _ROW + _top(lrow[_top(rl)]) if rl
                    else lit_before)
            le = lrow[r] & ((2 << lane) - 1)
            lt = lrow[r] & ((1 << lane) - 1)
            ln = gid - lane + _top(le) if le else rlit
            lp = gid - lane + _top(lt) if lt else rlit
            run_pos, prev_run_pos = gid - ln, gid - 1 - lp
            prev_eq = lp != gid - 1
            valid = gid < nv
            emits_run = eq[i] and valid and (run_pos % 62 == 0
                                              or gid == last_pos)
            flush = not eq[i] and prev_eq and prev_run_pos % 62 != 0
            key = _hash(p[i])
            lw = lmask[r][key] & ((1 << lane) - 1)
            rw = wmask[key] & ((1 << r) - 1)
            if lw:
                before = p[r * _ROW + _top(lw)]
            elif rw:
                before = p[_top(rw) * _ROW + _top(lmask[_top(rw)][key])]
            else:
                before = inval[key]
            hit = not eq[i] and before == p[i]
            d = _vsub4(p[i], prev[i])
            alpha_same = d >> 24 == 0
            dd = _vadd4(d, 0x00020202)
            is_diff = alpha_same and dd & 0x00FCFCFC == 0
            dl = _vadd4(_vsub4(d, ((d >> 8) & 0xFF) * 0x01010101),
                        0x00080008)
            gl = ((d >> 8) + 32) & 0xFF
            is_luma = (alpha_same and not is_diff and gl < 64
                       and dl & 0x00F000F0 == 0)
            is_rgb = alpha_same and not is_diff and not is_luma
            own0 = (key if hit else
                    0x40 | (dd & 3) << 4 | ((dd >> 8) & 3) << 2
                    | ((dd >> 16) & 3) if is_diff else
                    0x80 | gl if is_luma else 0xFE if is_rgb else 0xFF)
            own1 = (dl & 0xF) << 4 | ((dl >> 16) & 0xF) if is_luma else p[i]
            rec = own0 | own1 << 8
            own_len = (1 if hit or is_diff else 2 if is_luma
                       else 4 if is_rgb else 5)
            if eq[i]:
                st, ln_ = 0xC0 | (run_pos - 1) % 62, int(emits_run)
            elif flush:
                st, ln_ = (0xC0 | (prev_run_pos - 1) % 62) | rec << 8, \
                    own_len + 1
            else:
                st, ln_ = rec, own_len
            st &= (1 << 8 * ln_) - 1
            lo[gid], hi[gid], lens[gid] = st & _M32, st >> 32, ln_

    pending, running = list(range(nblk)), []
    while pending or running:
        if pending and len(running) < 6 and (not running
                                             or rng.random() < 0.3):
            running.append(block(pending.pop(0)))
            continue
        co = running[int(rng.integers(len(running)))]
        try:
            next(co)
        except StopIteration:
            running.remove(co)
    return (np.array(lo), np.array(hi), np.array(lens), np.array(cout),
            np.array(wr_out, np.uint8), seen)


def _carry_of(cout, wr):
    """The model's carry out through the wrapper's `_carry_out`."""
    return kstage._carry_out(torch.from_numpy(cout), torch.from_numpy(wr))


def _model_words(px4, n_valid=None, seed=0, **kw):
    """The design model through the wrapper's carry_in and _carry_out:
    (lo, hi, lens, prev_px, run, table, written), and the look-back
    counts."""
    k = _port_kwargs(**kw)
    carry = kstage._carry_args(px4.shape[0], n_valid, k["prev_in"],
                               k["run_in"], k["table_in"],
                               k["contains_last"], torch.device("cpu"))
    lo, hi, lens, cout, wr, seen = _words_by_design(px4, carry, seed)
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
    lo, hi, lens, cout, wr, _ = _words_by_design(px4, args, 1)
    _assert_equal((lo, hi, lens, *_carry_of(cout, wr)),
                  _want(case, px4, n_valid, kw))


def test_design_interleavings_wait_and_slide():
    """On the one-colour frame every column but the colour's slot walks
    back to the virtual block: in some seeded interleavings a group
    waits for an unpublished word, and looks back past 3 blocks."""
    px4, n_valid, kw = _case("one_colour_blocks")
    want = _want("one_colour_blocks", px4, n_valid, kw)
    total = {"wait": 0, "slide": 0}
    for seed in range(3):
        got, seen = _model_words(px4, n_valid, seed=seed, **kw)
        _assert_equal(got, want)
        for k in total:
            total[k] += seen[k]
    assert total["wait"] > 0 and total["slide"] > 0, total


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
        lo, hi, lens, cout, wr, _ = _words_by_design(tile, args, nv)
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
