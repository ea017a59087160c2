"""The algebra of the encode kernels' designs, on the CPU.

The CUDA kernels of qoi_tpu_torch/csrc/slide.cu (`qoi_slide_val`) and
csrc/encode_stage.cu run only on the card, where
tests/test_torch_kernels_gpu.py holds them against their twins. Here each
design is emulated step by step in numpy and held, exactly (tolerance 0,
an integer codec), against the port's plain twin and the JAX package's
Pallas kernel in interpret mode:

- slide_val: a row cut into k slices of `width` words, one per block of a
  cluster; each block places the alive events of its input slice into the
  slice that owns i - dist; the slices side by side are the slid row;
- encode_stage: 1024-pixel blocks of 32 rows of 32 pixels; per row the
  literals and the lanes that wrote each slot (bitmasks), per block the
  rows that wrote each slot; the block aggregates (the pixel its last
  writer of each slot left, the index of its last literal); the carries by
  nearest-predecessor look-back per column; then every pixel from those,
  with the kernel's byte-wise op tests and 64-bit staging word.
"""
import numpy as np
import pytest

import jax.numpy as jnp

from qoi_tpu.kernels import encode_stage as jstage
from qoi_tpu.kernels import slide as jslide
from qoi_tpu_torch import format as fmt
from qoi_tpu_torch.kernels import encode_stage as tstage
from qoi_tpu_torch.kernels import slide as tslide
from qoi_tpu_torch.models import pipeline as tpipe
from qoi_tpu_torch.ops import compact
from qoi_tpu_torch.utils import testimages
from torch_testutil import as_u32, to_torch

# ---------------------------------------------------------------- slide


def _cluster_slide(val, aux, k, width):
    """The cluster slide: block b of a row reads columns [b * width,
    (b + 1) * width) and stores each alive event with 0 <= dist <= i into
    slice (i - dist) // width at offset (i - dist) % width. Every output
    word is written at most once (asserted); the rest keep the slices'
    zero fill."""
    nseg, sw = val.shape
    assert k * width >= sw
    slices = np.zeros((nseg, k, width), np.int64)
    written = np.zeros((nseg, k, width), bool)
    for b in range(k):
        c0, c1 = b * width, min(sw, (b + 1) * width)
        i = np.arange(c0, c1)[None, :]
        a, v = aux[:, c0:c1], val[:, c0:c1]
        dist = a >> 1
        rows, cols = np.nonzero(((a & 1) != 0) & (dist >= 0) & (dist <= i))
        dst = i[0, cols] - dist[rows, cols]
        owner, off = dst // width, dst % width
        assert not written[rows, owner, off].any(), "two events, one word"
        written[rows, owner, off] = True
        slices[rows, owner, off] = v[rows, cols]
    return slices.reshape(nseg, k * width)[:, :sw]


def _records(n, kind, seed):
    """Staging records (lo, hi, lens) of n pixels, as the GPU tests make
    them: random lengths 0-6, all six bytes, or 5% of pixels with bytes."""
    rng = np.random.default_rng(seed)
    lens = {"mixed": lambda: rng.integers(0, 7, n),
            "dense6": lambda: np.r_[np.full(n - 1, 6), 5],
            "sparse": lambda: np.where(rng.random(n) < 0.05,
                                       rng.integers(1, 7, n), 0)}[kind]()
    b = rng.integers(1, 256, (n, 6)).astype(np.int64)
    b = np.where(np.arange(6)[None, :] < lens[:, None], b, 0)
    lo = b[:, 0] | b[:, 1] << 8 | b[:, 2] << 16 | b[:, 3] << 24
    hi = b[:, 4] | b[:, 5] << 8
    return to_torch(lo), to_torch(hi), to_torch(lens.astype(np.int64))


@pytest.fixture(scope="module")
def slide_cases():
    """(val, aux) event rows of ops/compact and the JAX slide of each:
    seg 500 gives sw = 1000 (a multiple of 4), seg 301 sw = 602."""
    out = {}
    for kind in ("mixed", "dense6", "sparse"):
        for n, seg in ((3000, 500), (1806, 301)):
            ev = compact.wordsum_events(*_records(n, kind, n), seg)
            val = ev.val.numpy().astype(np.int64) & 0xFFFFFFFF
            aux = ev.aux.numpy().astype(np.int64)
            want = jslide.slide_val(jnp.asarray(val.astype(np.uint32)),
                                    jnp.asarray(aux.astype(np.int32)),
                                    interpret=True)
            out[kind, 2 * seg] = (val, aux, as_u32(want))
    return out


@pytest.mark.parametrize("k", [1, 2, 3, 5, 8, "kernel"])
@pytest.mark.parametrize("sw", [1000, 602])
@pytest.mark.parametrize("kind", ["mixed", "dense6", "sparse"])
def test_cluster_slide_equals_twin_and_jax(slide_cases, kind, sw, k):
    """k = 3 and 5 leave sw a ragged last slice (k = 8 too, for 602);
    "kernel" is the wrapper's own choice for the width."""
    val, aux, want_jax = slide_cases[kind, sw]
    if k == "kernel":
        k, width = tslide.cluster_shape(sw)
    else:
        width = -(-sw // k)
    got = _cluster_slide(val, aux, k, width)
    want = tslide.slide_val_plain(to_torch(val), to_torch(aux))
    np.testing.assert_array_equal(got, as_u32(want))
    np.testing.assert_array_equal(got, want_jax)


@pytest.mark.parametrize("sw,k,width", [
    (8, 1, 8), (602, 1, 602), (4096, 1, 4096), (4098, 2, 2049),
    (4100, 2, 2052), (20002, 8, 2501), (40960, 8, 5120),
    (tslide.MAX_SW, 8, tslide.MAX_SLICE)])
def test_cluster_shape(sw, k, width):
    """k doubles until the slice is at most 4096 words (16 KB), to 8; a
    slice is a multiple of 4 words whenever the row is."""
    assert tslide.cluster_shape(sw) == (k, width)


def test_cluster_shape_refuses_rows_past_the_limit():
    with pytest.raises(ValueError, match=str(tslide.MAX_SW)):
        tslide.cluster_shape(tslide.MAX_SW + 1)


# ---------------------------------------------------------- encode_stage

_SEED = 0xFF000000
_ROW = 32


def _hash(p):
    return ((p & 0xFF) * 3 + ((p >> 8) & 0xFF) * 5 + ((p >> 16) & 0xFF) * 7
            + (p >> 24) * 11) & 63


def _top(m):
    return int(m).bit_length() - 1


def _vsub4(a, b):
    return sum((((a >> s) & 0xFF) - ((b >> s) & 0xFF) & 0xFF) << s
               for s in (0, 8, 16, 24))


def _vadd4(a, b):
    return sum((((a >> s) & 0xFF) + ((b >> s) & 0xFF) & 0xFF) << s
               for s in (0, 8, 16, 24))


def _staging_by_design(px4, n_valid, last_pos):
    """The kernel's computation, block by block: (staging (N, 6), lens)."""
    px = [int(x) for x in px4.view(np.uint32).reshape(-1)]
    n = len(px)
    blk_len = tstage._BLOCK
    rows = blk_len // _ROW
    prev = [_SEED] + px[:-1]
    eq = [px[i] == prev[i] or i >= n_valid for i in range(n)]
    nblk = n // blk_len
    none = {c: 0 for c in range(64)}
    none["lit"] = -1
    # 1. per row: literal lanes and, per slot, the lanes that wrote it;
    # per block: the rows that wrote each slot and the rows with a literal
    lrow = [sum(1 << ln for ln in range(_ROW) if not eq[r * _ROW + ln])
            for r in range(n // _ROW)]
    lmask = [[0] * 64 for _ in range(n // _ROW)]
    for i in range(n):
        if not eq[i]:
            lmask[i // _ROW][_hash(px[i])] |= 1 << (i % _ROW)
    aggs, carries = [], []
    for b in range(nblk):
        r0 = b * rows
        wmask = {c: sum(1 << r for r in range(rows) if lmask[r0 + r][c])
                 for c in range(64)}
        litmask = sum(1 << r for r in range(rows) if lrow[r0 + r])
        agg = {}
        for c in range(64):
            if wmask[c]:
                r = r0 + _top(wmask[c])
                agg[c] = px[r * _ROW + _top(lmask[r][c])]
        if litmask:
            r = r0 + _top(litmask)
            agg["lit"] = r * _ROW + _top(lrow[r])
        # 2. each column's carry: the aggregate of the nearest earlier
        # block that wrote it (the pass words are skipped), else `none`
        carry = {}
        for c in none:
            j = b - 1
            while j >= 0 and c not in aggs[j]:
                j -= 1
            carry[c] = aggs[j][c] if j >= 0 else none[c]
        aggs.append(agg)
        carries.append((carry, wmask, litmask))

    stag = np.zeros((n, 6), np.uint8)
    lens = np.zeros((n, 1), np.int32)
    for i in range(n):
        b, t = divmod(i, blk_len)
        base = b * blk_len
        carry, wmask, litmask = carries[b]
        r, lane = divmod(i, _ROW)
        rb = r - b * rows          # the row inside the block
        p, pv = px[i], prev[i]
        run_in = 0
        if b > 0:
            lim = min(max(n_valid, base - blk_len), base)
            if not last_pos < lim:
                e, lit = min(n_valid, base), carry["lit"]
                run_in = (e - 1 - lit if lit >= 0 else e) % 62
        # 3. the last literal at or before the pixel, and before it
        rl = litmask & ((1 << rb) - 1)
        rlit = ((base + _top(rl) * _ROW + _top(lrow[b * rows + _top(rl)]))
                if rl else -1)
        le = lrow[r] & ((2 << lane) - 1)
        lt = lrow[r] & ((1 << lane) - 1)
        ln = i - lane + _top(le) if le else rlit
        lp = i - lane + _top(lt) if lt else rlit
        run_pos = i - ln if ln >= 0 else t + 1 + run_in
        if t == 0:
            prev_eq, prev_run_pos = run_in > 0, run_in
        else:
            prev_eq = lp != i - 1
            prev_run_pos = i - 1 - lp if lp >= 0 else t + run_in
        emits_run = eq[i] and i < n_valid and (run_pos % 62 == 0
                                               or i == last_pos)
        flush = not eq[i] and prev_eq and prev_run_pos % 62 != 0
        # the last earlier writer of the slot: in the row, in the earlier
        # rows of the block, else the carry
        key = _hash(p)
        lw = lmask[r][key] & ((1 << lane) - 1)
        rw = wmask[key] & ((1 << rb) - 1)
        if lw:
            before = px[r * _ROW + _top(lw)]
        elif rw:
            rr = b * rows + _top(rw)
            before = px[rr * _ROW + _top(lmask[rr][key])]
        else:
            before = carry[key]
        hit = not eq[i] and before == p
        # byte-wise op tests
        d = _vsub4(p, pv)
        alpha_same = d >> 24 == 0
        dd = _vadd4(d, 0x00020202)
        is_diff = alpha_same and dd & 0x00FCFCFC == 0
        gg = ((d >> 8) & 0xFF) * 0x01010101
        dl = _vadd4(_vsub4(d, gg), 0x00080008)
        gl = ((d >> 8) + 32) & 0xFF
        is_luma = (alpha_same and not is_diff and gl < 64
                   and dl & 0x00F000F0 == 0)
        is_rgb = alpha_same and not is_diff and not is_luma
        own0 = (key if hit else
                0x40 | (dd & 3) << 4 | ((dd >> 8) & 3) << 2 | ((dd >> 16) & 3)
                if is_diff else 0x80 | gl if is_luma else
                0xFE if is_rgb else 0xFF)
        own1 = (dl & 0xF) << 4 | ((dl >> 16) & 0xF) if is_luma else p
        own = own0 | own1 << 8
        own_len = 1 if hit or is_diff else 2 if is_luma else (
            4 if is_rgb else 5)
        if eq[i]:
            st, ln_ = 0xC0 | (run_pos - 1) % 62, int(emits_run)
        elif flush:
            st, ln_ = (0xC0 | (prev_run_pos - 1) % 62) | own << 8, own_len + 1
        else:
            st, ln_ = own, own_len
        st &= (1 << 8 * ln_) - 1
        stag[i] = [(st >> 8 * c) & 0xFF for c in range(6)]
        lens[i, 0] = ln_
    return stag, lens


def _padded(img, cap):
    h, w, ch = img.shape
    px4 = tpipe.force_rgba(img, fmt.StreamDesc(w, h, ch))
    out = np.zeros((cap, 4), np.uint8)
    out[: len(px4)] = px4
    return out, len(px4)


_STAGE_CASES = {
    # every op and slot writes crossing 3 blocks
    "mixed": lambda: _padded(testimages.mixed(64, 48, 4, seed=4), 3072),
    # one literal (pixel 0): 63 slots never written, every look-back
    # runs to before block 0
    "one_colour": lambda: _padded(testimages.flat(64, 64, 4), 4096),
    # RGB palette repeats with a ragged tail of padding
    "palette_rgb_ragged": lambda: _padded(
        testimages.palette(50, 45, 3, colors=9, seed=5), 3072),
}


@pytest.mark.parametrize("last_pos", ["default", "mid", -1])
@pytest.mark.parametrize("case", list(_STAGE_CASES))
def test_staging_design_equals_twin_and_jax(case, last_pos):
    """last_pos: the default (n_valid - 1), mid-stream (1500: the run
    carry is cut after block 1) and -1 (cut after every block)."""
    px4, n = _STAGE_CASES[case]()
    lp = {"default": n - 1, "mid": 1500, -1: -1}[last_pos]
    got_s, got_l = _staging_by_design(px4, n, lp)
    want_s, want_l = tstage.encode_stage_plain(to_torch(px4), n, lp)
    np.testing.assert_array_equal(got_s, want_s.numpy())
    np.testing.assert_array_equal(got_l, want_l.numpy())
    jax_s, jax_l = jstage.encode_stage_pallas(jnp.asarray(px4), n,
                                              last_pos=lp, interpret=True)
    np.testing.assert_array_equal(got_s, np.asarray(jax_s))
    np.testing.assert_array_equal(got_l[:, 0],
                                  np.asarray(jax_l).reshape(-1))
