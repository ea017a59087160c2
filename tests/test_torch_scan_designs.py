"""The algebra of the sequential codec kernels' designs, on the CPU.

The CUDA kernels of qoi_tpu_torch/csrc/scan_codec.cu run only on the
card, where tests/test_torch_kernels_gpu.py holds them against their
twins. Here each design is emulated step by step in numpy and held,
exactly (tolerance 0, an integer codec), against the port's plain twin
and the JAX package's `lax.scan`s (`_decode_scan`, `_encode_scan`):

- decode_scan: a producer stages the stream into a ring of segments (at a
  16-byte aligned global base, so a ring byte sits at (q + shift) mod
  ring); windows at fixed 32-byte positions: a speculative chunk length
  at each byte, by five doubling steps each lane's chunk chain (a lane
  mask) and J^32, the chunk starts as the chain of the window's entry
  lane, the next window's entry from J^32 (the chunk-start FSM, one
  lookup a window),
  the `chunks_len` cut, the pixel-count prefix by ballots of the count
  bits, per-channel maps composed by a segmented scan between INDEX
  chunks, then the `n_px` cut, the INDEX values by warp fixpoint rounds
  over radix ballots of the hashes, each slot's last writer into the
  register table, the pixels stored by their chunks' lanes, and the
  tail fill;
- encode_scan: groups of 32 * warps pixels; `prev` is pixel i - 1; run
  membership, the run counter (cap 62, last pixel) from the last non-run
  index carried by ballots and a prefix max over the warps; the table hit
  from the last writer in the warp (match by hash), else the warps'
  per-slot last writers (a per-slot warp bitmask), else the table carried
  from earlier groups.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qoi_tpu.models import scan_codec as jscan
from qoi_tpu_torch import format as fmt
from qoi_tpu_torch.kernels import scan_codec as kscan
from scan_cases import (DECODE_CASES, ENCODE_CASES, SEED, decode_case,
                        encode_case, random_state, slot_of)

_jax_decode = jax.jit(jscan._decode_scan, static_argnums=(1,))
_jax_encode = jax.jit(jscan._encode_scan)

_FULL = 0xFFFFFFFF
#: the kernel's ring: segments of bytes and their count
_SEG, _NSEG = 2048, 8


def _top(m):
    return int(m).bit_length() - 1


def _vadd4(a, b):
    return sum((((a >> s) & 0xFF) + ((b >> s) & 0xFF) & 0xFF) << s
               for s in (0, 8, 16, 24))


def _apply(m, v, x):
    """The per-channel map (byte mask m: set; else add v mod 256) on x."""
    return (v & m) | (_vadd4(x, v) & ~m & _FULL)


def _compose(f, g):
    """f then g."""
    (fm, fv), (gm, gv) = f, g
    return fm | gm, (gv & gm) | (_vadd4(fv, gv) & ~gm & _FULL)


# ---------------------------------------------------------------- decode


def _map_of(b):
    """A chunk's map from its bytes b[0..4]: (byte mask, value)."""
    b1 = b[0]
    if b1 == fmt.OP_RGB:
        return 0x00FFFFFF, b[1] | b[2] << 8 | b[3] << 16
    if b1 == fmt.OP_RGBA:
        return _FULL, b[1] | b[2] << 8 | b[3] << 16 | b[4] << 24
    tag = b1 & 0xC0
    if tag == fmt.OP_DIFF:
        d = [((b1 >> 4) & 3) - 2, ((b1 >> 2) & 3) - 2, (b1 & 3) - 2]
    elif tag == fmt.OP_LUMA:
        vg = (b1 & 0x3F) - 32
        d = [vg - 8 + (b[1] >> 4), vg, vg - 8 + (b[1] & 15)]
    else:                                   # INDEX (a head), RUN
        d = [0, 0, 0]
    return 0, sum((x & 0xFF) << (8 * k) for k, x in enumerate(d))


class _Ring:
    """The producer's ring: segments of `seg` bytes of the stream, counted
    from a 16-byte aligned base `shift` bytes before byte 0, filled as far
    ahead as the free slots allow (the worst case for overwrites)."""

    def __init__(self, data, shift, seg, nseg, hi):
        self.d, self.shift, self.seg, self.nseg = data, shift, seg, nseg
        self.buf = np.zeros(seg * nseg, np.int64)
        self.tag = np.full(seg * nseg, -1, np.int64)   # global byte held
        self.nseg_total = -(-(shift + hi + 1) // seg) if hi >= 0 else 0
        self.filled = 0

    def advance(self, released):
        while (self.filled < self.nseg_total
               and self.filled < released + self.nseg):
            g = self.filled
            for a in range(g * self.seg, (g + 1) * self.seg):
                q = a - self.shift
                if 0 <= q < len(self.d):     # whole 16-byte vectors
                    self.buf[a % len(self.buf)] = self.d[q]
                    self.tag[a % len(self.buf)] = q
            self.filled += 1

    def read(self, q):
        a = (q + self.shift) % len(self.buf)
        return int(self.buf[a]), int(self.tag[a]) == q


def decode_by_design(data, n_px, chunks_len, state65, shift=0, seg=_SEG,
                     nseg=_NSEG, stats=None):
    """The decode kernel's computation: (pixels (n_px,) u32 values, exit
    state (65,) u32 values)."""
    d = [int(x) for x in data]
    last = len(d) - 1
    if last < 0:
        chunks_len = 0
    hi = min(len(d), chunks_len + 4) - 1
    ring = _Ring(d, shift, seg, nseg, hi)
    lastbyte = d[last] if last >= 0 else 0
    st = [int(x) & _FULL for x in state65]
    px, table = st[0], st[1:]
    out = np.full(n_px, -1, np.int64)
    lanes = range(32)
    rounds_max = 0

    def byte(q, need):
        if q > last:
            return lastbyte
        v, ok = ring.read(q)
        assert ok or not need, f"ring byte {q} not staged"
        return v

    def jumps(w0):
        """Step 1, at the window's fixed position w0: the bytes, the
        length of a chunk starting at each lane, and by five doubling
        steps each lane's chunk chain in the window (a lane mask) and
        J^32, where it leaves the window (32 chunks on, sticky once
        past it)."""
        ring.advance((w0 + shift) // seg)
        # the segment of the window's last needed byte must have arrived
        assert w0 > hi or ring.filled > (min(w0 + 35, hi) + shift) // seg
        b = [[byte(w0 + j + k, False) for k in range(5)] for j in lanes]
        ln = [4 if x[0] == fmt.OP_RGB else 5 if x[0] == fmt.OP_RGBA
              else 2 if x[0] & 0xC0 == fmt.OP_LUMA else 1 for x in b]
        jump, chain = [j + ln[j] for j in lanes], [1 << j for j in lanes]
        for _ in range(5):
            chain = [chain[j] | chain[jump[j]] if jump[j] < 32 else chain[j]
                     for j in lanes]
            jump = [jump[jump[j]] if jump[j] < 32 else jump[j]
                    for j in lanes]
        return b, ln, chain, jump

    w0, e, i0 = 0, 0, 0           # the window's position, entry lane
    while i0 < n_px and w0 + e < chunks_len:
        b, ln, chain, j32 = jumps(w0)
        # the chunk starts: the chain from the entry lane
        limit = chunks_len - w0
        cand = chain[e] & ((1 << min(limit, 32)) - 1)
        # the next window's entry: where the chain from lane e leaves
        e_next = j32[e] - 32
        assert 0 <= e_next <= 4
        # 2. pixel counts and their inclusive prefix, from six ballots of
        # the count's bits
        is_run = [b[j][0] & 0xC0 == fmt.OP_RUN and b[j][0] < fmt.OP_RGB
                  for j in lanes]
        cnt = [((b[j][0] & 63) + 1 if is_run[j] else 1) if cand >> j & 1
               else 0 for j in lanes]
        cb = [sum(1 << j for j in lanes if cnt[j] >> k & 1)
              for k in range(6)]
        inc = [sum(bin(cb[k] & ((2 << j) - 1)).count("1") << k
                   for k in range(6)) for j in lanes]
        off = [inc[j] - cnt[j] for j in lanes]
        # 3. maps of the candidate chunks, the segmented scan between INDEX
        # heads; steps 1-3 read bytes and the entry only, so the kernel
        # runs them for the next windows beside steps 4-6 of this one
        idx = sum(1 << j for j in lanes
                  if cand >> j & 1 and b[j][0] & 0xC0 == fmt.OP_INDEX)
        e_ = [_map_of(b[j]) if cand >> j & 1 and not idx >> j & 1
              else (0, 0) for j in lanes]
        hb = [_top(idx & ((2 << j) - 1)) for j in lanes]
        for dd in (1, 2, 4, 8, 16):
            e_ = [_compose(e_[j - dd], e_[j]) if j >= dd and hb[j] <= j - dd
                  else e_[j] for j in lanes]
        # the n_px cut: the active chunks are a prefix of the candidates
        act = sum(1 << j for j in lanes if cand >> j & 1
                  and i0 + off[j] < n_px)
        idx &= act
        for j in lanes:                     # an active chunk's bytes
            if act >> j & 1:
                for k in range(ln[j]):
                    byte(w0 + j + k, True)
        # 4. INDEX values: fixpoint rounds from the entry table's slots
        tabv = [table[b[j][0] & 63] for j in lanes]
        val = list(tabv)
        rounds = 0
        while True:
            rounds += 1
            base = [val[hb[j]] if hb[j] >= 0 else px for j in lanes]
            pxs = [_apply(*e_[j], base[j]) for j in lanes]
            h = [slot_of(x) for x in pxs]
            ball = [sum(1 << j for j in lanes if act >> j & 1
                        and h[j] >> bit & 1) for bit in range(6)]

            def writers(s):
                m = act
                for bit in range(6):
                    m &= ball[bit] if s >> bit & 1 else ~ball[bit] & _FULL
                return m

            new = list(val)
            for k in lanes:
                if idx >> k & 1:
                    m = writers(b[k][0] & 63) & ((1 << k) - 1)
                    new[k] = pxs[_top(m)] if m else tabv[k]
            changed = new != val
            val = new
            if not changed:
                break
        assert rounds <= bin(idx).count("1") + 1
        rounds_max = max(rounds_max, rounds)
        # 5. each slot takes its last writer; the window's exit px
        for s in range(64):
            m = writers(s)
            if m:
                table[s] = pxs[_top(m)]
        top = _top(act)
        px = pxs[top]
        # 6. each active chunk stores its pixels (a lane each, so a window
        # of single pixels is one coalesced store)
        for j in lanes:
            if act >> j & 1:
                for r in range(min(cnt[j], n_px - i0 - off[j])):
                    assert out[i0 + off[j] + r] == -1, "pixel written twice"
                    out[i0 + off[j] + r] = pxs[j]
        i0 += min(inc[top], n_px - i0)
        w0, e = w0 + 32, e_next
    out[i0:] = px                           # the tail: the last px repeats
    assert (out >= 0).all()
    if stats is not None:
        stats["rounds_max"] = rounds_max
    return out, np.array([px] + table, np.int64)


def _decode_twins(data, n_px, clen, state):
    """(pixels, exit65) of the port's twin and of JAX, as u32 values."""
    arr = np.frombuffer(data, np.uint8).copy()
    tw_px, tw_st = kscan.decode_scan_plain(torch.from_numpy(arr), n_px, clen,
                                           torch.from_numpy(state))
    tw = (tw_px.numpy().astype(np.int64) & _FULL,
          tw_st.numpy().astype(np.int64) & _FULL)
    st8 = state.view(np.uint8).reshape(65, 4)
    j_px, (j_e, j_t) = _jax_decode(jnp.asarray(arr), n_px, jnp.int32(clen),
                                   jnp.asarray(st8[0]), jnp.asarray(st8[1:]))
    jx = (np.asarray(j_px).reshape(n_px, 4).copy().view(np.uint32)
          .reshape(-1).astype(np.int64),
          np.concatenate([np.asarray(j_e)[None], np.asarray(j_t)]).copy()
          .view(np.uint32).reshape(-1).astype(np.int64))
    return tw, jx


@pytest.mark.parametrize("geometry", ["kernel", "small_ring"])
@pytest.mark.parametrize("case", DECODE_CASES)
def test_decode_design_equals_twin_and_jax(case, geometry):
    """From a random entry state; `small_ring` stages through 4 segments
    of 64 bytes at a misaligned base, so the ring wraps many times at
    these sizes."""
    data, n_px, clen = decode_case(case)
    state = random_state(len(data) + n_px)
    kw = {} if geometry == "kernel" else dict(shift=7, seg=64, nseg=4)
    got = decode_by_design(np.frombuffer(data, np.uint8), n_px, clen, state,
                           **kw)
    tw, jx = _decode_twins(data, n_px, clen, state)
    for g, t, j in zip(got, tw, jx):
        np.testing.assert_array_equal(g, t)
        np.testing.assert_array_equal(g, j)


def test_decode_design_adversarial_takes_one_round():
    """The adversarial bytes read one slot the walk never changes, or that
    its own px keeps: the first INDEX round already holds (no change)."""
    data, n_px, clen = decode_case("adversarial")
    stats = {}
    decode_by_design(np.frombuffer(data, np.uint8), n_px, clen, random_state(3),
                     stats=stats)
    assert stats["rounds_max"] == 1


def test_decode_design_empty_stream():
    """No bytes: the entry px repeats and the state passes through."""
    got = decode_by_design(np.zeros(0, np.uint8), 5, 0, random_state(4))
    want = kscan.decode_scan_plain(torch.zeros(0, dtype=torch.uint8), 5, 0,
                                   torch.from_numpy(random_state(4)))
    for g, t in zip(got, want):
        np.testing.assert_array_equal(g, t.numpy().astype(np.int64) & _FULL)


# ---------------------------------------------------------------- encode


def encode_by_design(px32, warps=32):
    """The encode kernel's computation in groups of 32 * warps pixels:
    (staging (N, 6) uint8, lens (N,) int32)."""
    px = [int(x) & _FULL for x in px32]
    n = len(px)
    grp = 32 * warps
    table = [0] * 64
    last_lit = -1                     # last non-run index before the group
    stag = np.zeros((n, 6), np.uint8)
    lens = np.zeros(n, np.int32)
    lit, lit_len = (x.numpy() for x in kscan.classify_literal(
        torch.tensor(np.array(px, np.uint32).view(np.uint8).reshape(-1, 4)),
        torch.tensor(np.array([SEED] + px[:-1], np.uint32).view(np.uint8)
                     .reshape(-1, 4))))
    for g0 in range(0, n, grp):
        ids = [g0 + t for t in range(grp)]
        valid = [i < n for i in ids]
        p = [px[i] if v else 0 for i, v in zip(ids, valid)]
        prev = [(px[i - 1] if i > 0 else SEED) if v else 0
                for i, v in zip(ids, valid)]
        lit_t = [v and p[t] != prev[t] for t, v in enumerate(valid)]
        # last non-run index: ballots in the warp, prefix max over warps
        ball = [sum(1 << ln for ln in range(32) if lit_t[w * 32 + ln])
                for w in range(warps)]
        wlast = [g0 + w * 32 + _top(ball[w]) if ball[w] else -1
                 for w in range(warps)]
        before = [max([last_lit] + wlast[:w]) for w in range(warps)]
        h = [slot_of(x) for x in p]
        # per warp: lanes of each slot (match), the last writer's pixel
        wmask = [0] * 64
        lastw = {}
        for w in range(warps):
            for s in range(64):
                m = sum(1 << ln for ln in range(32)
                        if lit_t[w * 32 + ln] and h[w * 32 + ln] == s)
                if m:
                    lastw[w, s] = p[w * 32 + _top(m)]
                    wmask[s] |= 1 << w
        for t in range(grp):
            if not valid[t]:
                continue
            i, w, ln = ids[t], t // 32, t % 32
            lt = (1 << ln) - 1
            m_le = ball[w] & ((2 << ln) - 1)
            last_le = g0 + w * 32 + _top(m_le) if m_le else before[w]
            if not lit_t[t]:
                run = (i - last_le - 1) % fmt.RUN_CAP + 1
                stag[i, 0] = fmt.OP_RUN | (run - 1)
                lens[i] = int(run == fmt.RUN_CAP or i == n - 1)
                continue
            m_lt = ball[w] & lt
            last_lt = g0 + w * 32 + _top(m_lt) if m_lt else before[w]
            run_before = (i - 1 - last_lt) % fmt.RUN_CAP
            s = h[t]
            mm = sum(1 << k for k in range(ln)
                     if lit_t[w * 32 + k] and h[w * 32 + k] == s)
            if mm:
                tv = p[w * 32 + _top(mm)]
            elif wmask[s] & ((1 << w) - 1):
                tv = lastw[_top(wmask[s] & ((1 << w) - 1)), s]
            else:
                tv = table[s]
            if tv == p[t]:
                own, own_len = [fmt.OP_INDEX | s, 0, 0, 0, 0], 1
            else:
                own, own_len = list(lit[i]), int(lit_len[i])
            if run_before:
                stag[i] = [fmt.OP_RUN | (run_before - 1)] + own
                lens[i] = own_len + 1
            else:
                stag[i] = own + [0]
                lens[i] = own_len
        for s in range(64):
            if wmask[s]:
                table[s] = lastw[_top(wmask[s]), s]
        last_lit = max([last_lit] + wlast)
    return stag, lens


@pytest.mark.parametrize("warps", [2, 32])
@pytest.mark.parametrize("case", ENCODE_CASES)
def test_encode_design_equals_twin_and_jax(case, warps):
    """Groups of 64 and of 1024 (the kernel's) pixels; every case but
    `one` leaves a partial last group at 64."""
    px = encode_case(case)
    got = encode_by_design(px, warps)
    want = kscan.encode_scan_plain(torch.from_numpy(px.view(np.int32)))
    jx = _jax_encode(jnp.asarray(px.view(np.uint8).reshape(-1, 4)))
    for g, t, j in zip(got, want, jx):
        np.testing.assert_array_equal(g, t.numpy())
        np.testing.assert_array_equal(g, np.asarray(j))


@pytest.mark.parametrize("case", ["adversarial", "mixed", "soup", "cut500",
                                  "edge", "own_group_index", "n_px_below",
                                  "n_px_above", "rgb_photo"])
def test_exit_state_follows_from_the_pixels(case):
    """kernels/scan_codec.exit_state_of, the full-size check of a tile's
    exit state, equals the twin's exit state wherever a chunk was read."""
    data, n_px, clen = decode_case(case)
    state = torch.from_numpy(random_state(n_px))
    px, exit65 = kscan.decode_scan_plain(
        torch.frombuffer(bytearray(data), dtype=torch.uint8), n_px, clen,
        state)
    assert torch.equal(kscan.exit_state_of(px, state), exit65)
