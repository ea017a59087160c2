"""Blocked symbolic state-machine decoder (port of
qoi_tpu/models/decode_v3.py, the `_decode_device` main path).

The reference decoder (qoi.h:488-590) is a sequential recurrence on the
state S = (px, index[64]). Once each chunk's WRITTEN table slot w is
known, every chunk is an affine-selection transform of S, and such
transforms compose associatively. Written slots start from an affine
hash scan (`_initial_w`, as `initial_w_scan` from the bytes: one kernel
launch on the card) and a certified fixpoint corrects them:

  pass 1  per-block symbolic 65-entry maps, one lane per block
          (kernels/block_maps.py: the CUDA kernel on the card)
  pass 2  compose the block maps, apply them to the entry state
  pass 3  numeric px after every byte from pass 1's per-position
          symbolic px entries
  check   w == hash(px) everywhere certifies the decode; otherwise
          the surgical second round rebuilds only the dirty blocks,
          then the anchored rebuild gives the next w, up to 12 rounds,
          and a stalled mismatch count bails to `_decode_ladder`
  expand  per-byte px -> pixel plane (kernels/expand.py)

The entry state (`entry65`, the packed px and 64 slots, default the seed
px and an empty table) and the exit state let the streamed decoder
(models/streamed.py) chain tiles.

u32 values are int64 in [0, 2**32) (see _bits); kernel planes are int32
bit patterns. The fixpoint loop is a Python loop that reads the mismatch
count to the host once per round. The dense expand (`dense=True`) first
packs the chunk starts' records to the front (`_compact_chunks`, whose
two-plane slide is kernels/slide.slide_val2). `apply="scan"` (of
`_decode_core`, `_decode_device` and `_resolve_p`) re-scans pass 3
numerically (kernels/numeric_scan.py), the differential anchor of
`_apply_symbolic`; it leaves the surgical round off, as the JAX package
does. `decode_group` loops over its streams where the JAX package vmaps
them.

Spans (utils/profiling.annotate; record_function ranges while a profiler
runs, free otherwise): `qoi.decode` is one stream's `_decode_device`, and
inside it `qoi.decode.fields`, `.estimate` (the initial scan, and each
anchored rebuild inside the fixpoint), `.fixpoint` (from w0 to the
fixpoint's end; in each round `.maps` = pass 1, `.compose` = pass 2,
`.apply` = pass 3 and `.certify` = the check and its host read) and
`.expand`.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .. import format as fmt
from .._bits import swar_sub, to_i32, u32
from ..kernels.block_maps import (_CLS_ADD, _CLS_INDEX, _CLS_RGB, _CLS_RGBA,
                                  block_maps)
# the fields' and the initial leaf's arithmetic live beside the scan kernel
# that builds them from the bytes (kernels/blocked_scan.py)
from ..kernels.blocked_scan import (_SEED_HASH, _chunk_fields, _hash_packed,
                                    _initial_apply, _initial_leaf, anch_scan,
                                    initial_scan, initial_w_scan)
from ..kernels.expand import expand_px
from ..kernels.numeric_scan import numeric_scan
from ..kernels.slide import slide_val2
from ..ops import fsm
from ..ops.compact import assemble_rows
from ..ops.scans import assoc_scan, exclusive_cumsum
from ..utils.profiling import annotate
from . import decode_pipeline as v1

_ABS = 65  # per-channel root symbol: absolute value (no entry dependence)
_MAX_ROUNDS = 12

#: cap on the scan length B (positions per block), as in the JAX package
_SCAN_B_MAX = 8192


def _fields(data: torch.Tensor, chunks_len):
    """Per-byte chunk fields. data: (M,) uint8. Returns (starts, cls, r6,
    d32, lit32, npix), (M,) each (bool, then int64)."""
    starts = fsm.chunk_starts(data, chunks_len)
    return (starts, *_chunk_fields(data, starts))


def _entry_hash(entry_px32):
    """Hash of the incoming px: the seed's, or that of a 0-d u32 tensor."""
    return _SEED_HASH if entry_px32 is None else _hash_packed(entry_px32)


def _initial_w(cls, r6, d32, lit32, npix, entry_px32=None):
    """Optimistic per-byte written-slot estimate as ONE affine scan over
    the coupled (alpha, hash) state, co-scanned with the pixel-offset
    cumsum:

        a' = ra ? va : a                 (an RGBA literal sets alpha)
        h' = g*h + t*a + e   (mod 64)    (g, t, e per op class)

    on `_initial_leaf`'s packed coefficients (`initial_scan`: the CUDA
    kernel of kernels/blocked_scan.py on the card; the leaf is built in
    plain torch). Exact unless an INDEX changed alpha between RGBA and
    RGB chunks (the fixpoint corrects that). `entry_px32` (0-d int64 u32,
    default the seed) is the incoming px of a chained tile: its hash
    seeds h and its alpha seeds a. Returns (w, pix_off), both (M,)
    int64. `_decode_core` takes `initial_w_scan`, which builds the leaves
    from the bytes in the kernel; this form from the fields stays as its
    plain route."""
    ps, inc = initial_scan(_initial_leaf(cls, r6, d32, lit32).to(torch.int32),
                           npix.to(torch.int32))
    return _initial_apply(ps, inc, npix, entry_px32)


def _anch_leaf(cls, r6, d32, px32):
    """Packed (g, e) affine leaf of the anchored-w recurrence."""
    m3, m5, m7, _ = fmt.HASH_MULTIPLIERS
    dh = (m3 * (d32 & 0xFF) + m5 * ((d32 >> 8) & 0xFF)
          + m7 * ((d32 >> 16) & 0xFF)) & 63
    is_reset = (cls == _CLS_RGB) | (cls == _CLS_RGBA) | (cls == _CLS_INDEX)
    g = (~is_reset).to(torch.int64)
    e = torch.where(cls == _CLS_INDEX, r6,
        torch.where(is_reset, _hash_packed(px32),
        torch.where(cls == _CLS_ADD, dh, 0)))
    return g | (e << 1)


def _anchored_w(cls, r6, d32, px32, entry_px32=None):
    """Next-round written-slot estimate from a resolve's px, re-anchored
    at every reset chunk: INDEX r writes slot r (the table invariant),
    RGB/RGBA write hash(px), ADD/RUN add hash(delta) mod 64. Errors
    remain only at RGB chunks whose resolved alpha was poisoned."""
    leaf = _anch_leaf(cls, r6, d32, px32).to(torch.int32)
    ps = anch_scan(leaf[None])[0].to(torch.int64)
    return ((ps & 1) * _entry_hash(entry_px32) + (ps >> 1)) & 63


def _anchored_w_rows(cls_g, r6_g, d32_g, px_g, entry_h):
    """`_anchored_w` over independent blocks: (K, b) planes scanned along
    the last axis, one entry hash per row ((K,) int64) -- the surgical
    round's narrow rebuild."""
    ps = anch_scan(_anch_leaf(cls_g, r6_g, d32_g, px_g).to(torch.int32))
    ps = ps.to(torch.int64)
    return ((ps & 1) * entry_h[:, None] + (ps >> 1)) & 63


def _compose_entry_states(root: torch.Tensor, val: torch.Tensor,
                          entry65=None, return_exit: bool = False):
    """Pass 2: inclusive compose of the (65, nb) block maps (int32 bit
    patterns) along the blocks, then application to the stream's entry
    state -> the packed numeric 65-entry state at every block ENTRY,
    (65, nb) int64 u32. `entry65` ((65,) int64 u32: px + 64 slots) is the
    entry state, default the seed px and an empty table. `return_exit`
    also returns the state after the LAST block ((65,) int64 u32), the
    stream's exit state. The compose looks roots up over the 65-entry
    axis with `gather`; the scan over blocks is `assoc_scan`."""
    shifts = torch.tensor([0, 8, 16, 24], device=root.device)[:, None, None]
    rc = (root.to(torch.int64)[None] >> shifts) & 0xFF   # (4, 65, nb)
    vc = (val.to(torch.int64)[None] >> shifts) & 0xFF

    def comb(a, b):
        (ar, av), (br, bv) = a, b
        idx = br.clamp(max=_ABS - 1)
        is_abs = br == _ABS
        return (torch.where(is_abs, _ABS, ar.gather(1, idx)),
                torch.where(is_abs, bv, (av.gather(1, idx) + bv) & 0xFF))

    rs, vs = assoc_scan(comb, (rc, vc))
    if entry65 is None:
        init = torch.zeros((4, 65), dtype=torch.int64, device=root.device)
        init[:, 0] = torch.tensor(fmt.SEED_PIXEL, device=root.device)
    else:
        init = (entry65.to(torch.int64)[None] >> shifts[:, :, 0]) & 0xFF
    nb = root.shape[1]
    looked = init[:, :, None].expand(4, 65, nb).gather(
        1, rs.clamp(max=_ABS - 1))
    applied = torch.where(rs == _ABS, vs, (vs + looked) & 0xFF)
    entry = torch.cat([init[:, :, None], applied[:, :, :-1]], dim=2)
    packed = entry[0] | entry[1] << 8 | entry[2] << 16 | entry[3] << 24
    if not return_exit:
        return packed
    ex = applied[:, :, -1]
    return packed, ex[0] | ex[1] << 8 | ex[2] << 16 | ex[3] << 24


def _apply_symbolic(proot: torch.Tensor, pval: torch.Tensor,
                    entry: torch.Tensor) -> torch.Tensor:
    """Pass 3: numeric px after every position (b, nb) from pass 1's
    per-position symbolic px entries (int32) and the per-block entry
    states (65, nb) u32. Per channel: px_c = pval_c if proot_c is
    absolute, else (entry[proot_c]_c + pval_c) mod 256 -- one gather over
    the 65-entry axis per channel."""
    proot, pval = proot.to(torch.int64), pval.to(torch.int64)
    px = torch.zeros_like(pval)
    for sh in (0, 8, 16, 24):
        r = (proot >> sh) & 0xFF
        v = (pval >> sh) & 0xFF
        looked = ((entry >> sh) & 0xFF).gather(0, r.clamp(max=_ABS - 1))
        px |= torch.where(r == _ABS, v, (looked + v) & 0xFF) << sh
    return px


def _scan_block_len(m: int) -> int:
    """Scan length B (positions per block): lanes nb = m / B stay wide
    while the sequential steps stay bounded."""
    b = 16
    while b < _SCAN_B_MAX and b * 64 <= m:
        b <<= 1
    return b


def _pos_major(x: torch.Tensor, m: int, b: int) -> torch.Tensor:
    """(M,) -> (B, nb): position i of block k at [i, k]."""
    return x.reshape(m // b, b).T.contiguous()


def _check_apply(apply: str) -> None:
    """Raise ValueError unless `apply` names a pass 3."""
    if apply not in ("vector", "scan"):
        raise ValueError(f"apply must be 'vector' or 'scan', got {apply!r}")


def _resolve_p(base_p, d32_p, lit32_p, w, m: int, b: int, entry65=None,
               apply: str = "vector"):
    """One full symbolic resolve given written slots w, from the
    loop-invariant position-major int32 planes (base_p = cls | r6 << 9,
    d32_p, lit32_p). Returns (px32 (M,) u32 after every byte, exit65,
    extra). `apply` picks pass 3: "vector" applies pass 2's entry states
    to pass 1's per-position symbolic px entries (`_apply_symbolic`), and
    extra is (root, val, entry, proot): the pass-1 maps, the block entry
    states and the per-position px roots, which the surgical round reuses;
    "scan" re-scans every block lane numerically from its entry state
    (kernels/numeric_scan.py: the CUDA kernel on the card), the
    differential anchor of the vector form, and extra is None."""
    _check_apply(apply)
    with annotate("qoi.decode.maps"):
        meta_p = base_p | (_pos_major(w, m, b) << 3).to(torch.int32)
        root, val, proot, pval = block_maps(meta_p, d32_p, lit32_p)
    if apply == "scan":
        with annotate("qoi.decode.compose"):
            entry = _compose_entry_states(root, val, entry65)
        with annotate("qoi.decode.apply"):
            px, exit65 = numeric_scan(meta_p, d32_p, lit32_p, to_i32(entry))
            return u32(px).T.reshape(m), u32(exit65), None
    with annotate("qoi.decode.compose"):
        entry, exit65 = _compose_entry_states(root, val, entry65,
                                              return_exit=True)
    with annotate("qoi.decode.apply"):
        px = _apply_symbolic(proot, pval, entry).T.reshape(m)
    return px, exit65, (root, val, entry, proot)


def _resolve(cls, r6, w, d32, lit32, m: int, b: int, entry65=None,
             apply: str = "vector"):
    """One full symbolic resolve given written slots w, from the flat
    (M,) planes (a wrapper of `_resolve_p`). Returns (px32 (M,) u32,
    exit65 (65,) u32)."""
    base_p = _pos_major((cls | (r6 << 9)).to(torch.int32), m, b)
    px, exit65, _ = _resolve_p(base_p, _pos_major(to_i32(d32), m, b),
                               _pos_major(to_i32(lit32), m, b), w, m, b,
                               entry65, apply)
    return px, exit65


#: surgical round geometry: W windows of WB consecutive blocks, K = 64
#: block lanes for the narrow pass 1
_SURG_W, _SURG_WB = 8, 8


def _surgical_windows(mis_b: torch.Tensor):
    """Cover the dirty blocks (a block is dirty when it or the block
    before it has a round-1 mismatch) with W windows of WB blocks,
    greedily: each window starts at the
    first dirty block past the previous one's end. Returns the (K,) int64
    block ids of the windows' lanes on mis_b's device, or None when W
    windows do not cover every dirty block.

    A window past nbk - WB is clamped to start at nbk - WB, so that it
    stays inside the stream. It then still covers its dirty blocks, but
    it can OVERLAP the window before it: a block may appear in two
    windows. Both copies of such a block are computed from the same
    inputs, so they carry equal rows and either write is exact. Lanes of
    windows that were not needed get the id nbk (out of range), and the
    round drops them before any write. One host read: the (nbk,) flags."""
    nbk = mis_b.shape[0]
    dirty = mis_b.cpu().numpy()
    dirty[1:] |= dirty[:-1].copy()
    starts = []
    nxt = 0
    for s in np.flatnonzero(dirty):
        if s >= nxt:
            if len(starts) == _SURG_W:
                return None
            starts.append(min(int(s), nbk - _SURG_WB))
            nxt = s + _SURG_WB
    ids = np.full((_SURG_W, _SURG_WB), nbk, np.int64)
    for j, s in enumerate(starts):
        ids[j] = s + np.arange(_SURG_WB)
    return torch.from_numpy(ids.reshape(-1)).to(mis_b.device)


def _surgical_round(flat, px1, w0, w0i, extra1, ids, m: int, b: int,
                    entry65=None):
    """Round 2 rebuilt over the dirty windows only (qoi_tpu's round-5
    surgical round). Round-1 mismatches are sparse and the anchored
    rebuild's fix is local, so w and the pass-1 maps are rebuilt only for
    the K window blocks (`ids`, from `_surgical_windows`): the anchored
    scan per block from the w0 chain entering it, then the block_maps
    kernel over K lanes. Pass 2 recomposes over the patched maps. A clean
    block's px follows from the exact identity
        px2 = px1 (+) (entry2 - entry1)[proot1]   (per channel, mod 256)
    since its map did not change; a dirty block gets a fresh apply.

    flat: (cls | r6 << 9, d32, lit32), (M,) int64 each. Returns (px2, w2,
    exit2); the caller's full certificate decides whether they stand."""
    nbk = m // b
    base_f, d32, lit32 = flat
    root1, val1, entry1, proot1 = extra1
    ok = ids < nbk
    idc = ids.clamp(max=nbk - 1)
    keep = ids[ok]

    def rows(x):
        """(M,) -> (K, b): the window blocks' positions."""
        return x.reshape(nbk, b)[idc]

    base_g, d32_g, lit32_g, px_g = (rows(x) for x in (base_f, d32, lit32,
                                                      px1))
    cls_g, r6_g = base_g & 7, (base_g >> 9) & 63
    starts_g = cls_g != 0
    entry_h = _entry_hash(None if entry65 is None else entry65[0])
    seed_h = torch.where(idc == 0, entry_h,
                         w0i[(idc * b - 1).clamp(min=0)])
    w1_g = torch.where(starts_g, _anchored_w_rows(cls_g, r6_g, d32_g, px_g,
                                                  seed_h), 0)
    root_g, val_g, proot_g, pval_g = block_maps(
        (base_g | w1_g << 3).T.to(torch.int32).contiguous(),
        to_i32(d32_g).T.contiguous(), to_i32(lit32_g).T.contiguous())
    root2, val2 = root1.clone(), val1.clone()
    root2[:, keep] = root_g[:, ok]
    val2[:, keep] = val_g[:, ok]
    entry2, exit2 = _compose_entry_states(root2, val2, entry65,
                                          return_exit=True)
    px2 = _apply_symbolic(proot1, _pos_major(px1, m, b),
                          swar_sub(entry2, entry1)).T.reshape(nbk, b)
    px2[keep] = _apply_symbolic(proot_g, pval_g, entry2[:, idc]).T[ok]
    w2 = w0.clone().reshape(nbk, b)
    w2[keep] = w1_g[ok]
    return px2.reshape(m), w2.reshape(m), exit2


def _decode_core(data: torch.Tensor, chunks_len, max_rounds: int = _MAX_ROUNDS,
                 entry65=None, apply: str = "vector", surgical: bool = True):
    """Full chunk-level decode to per-byte px values + bookkeeping.
    data: (M,) uint8 with M a bucket size. `entry65` ((65,) int64 u32:
    px + 64 slots, default the seed) is the incoming state of a chained
    tile. Returns (px32 (M,) int64 u32, starts, npix, pix_off, converged
    (bool), rounds (int), exit65 ((65,) int64 u32, valid only when
    converged)). `apply` picks pass 3 (see `_resolve_p`). `surgical`
    allows the narrow second round; it engages only with apply="vector"
    (whose pass-1 px roots it reuses), max_rounds > 1 and nbk >= 256
    blocks."""
    _check_apply(apply)
    m = data.shape[0]
    b = _scan_block_len(m)
    nbk = m // b
    with annotate("qoi.decode.fields"):
        starts, cls, r6, d32, lit32, npix = _fields(data, chunks_len)
    entry_px32 = None if entry65 is None else entry65[0]
    # _initial_w's estimate with its leaves built from the bytes in the
    # kernel (no leaf plane on the card)
    with annotate("qoi.decode.estimate"):
        w0i, pix_off = initial_w_scan(data, starts, entry_px32)
    with annotate("qoi.decode.fixpoint"):
        w0 = torch.where(starts, w0i, 0)

        # loop-invariant position-major planes, transposed once per decode
        base_f = cls | (r6 << 9)
        planes = (_pos_major(base_f.to(torch.int32), m, b),
                  _pos_major(to_i32(d32), m, b),
                  _pos_major(to_i32(lit32), m, b))

        def mismatches(px, w):
            """certificate: w == hash(px(w)) everywhere forces exactness"""
            return torch.where(starts, _hash_packed(px), 0) != w

        def round_(w, prev_bad):
            px, exit65, extra = _resolve_p(*planes, w, m, b, entry65, apply)
            with annotate("qoi.decode.certify"):
                mis = mismatches(px, w)
                bad = int(mis.sum())  # the one host read per round
            # bail (-1) when the mismatch count stops shrinking: only
            # non-canonical streams stall now
            if bad > 0 and bad >= prev_bad:
                bad = -1
            return px, exit65, bad, extra, mis

        # round 1 is peeled: the anchored rebuild runs only for streams
        # that need a second round
        px, exit65, bad, extra, mis = round_(w0, 0x7FFFFFFF)
        rounds = 1
        if (bad > 0 and apply == "vector" and surgical and max_rounds > 1
                and nbk >= 256):
            ids = _surgical_windows(mis.reshape(nbk, b).any(dim=1))
            if ids is not None:
                px, w, exit65 = _surgical_round((base_f, d32, lit32), px,
                                                w0, w0i, extra, ids, m, b,
                                                entry65)
                with annotate("qoi.decode.certify"):
                    bad = int(mismatches(px, w).sum())
                rounds = 2
        del extra, mis
        while bad > 0 and rounds < max_rounds:
            with annotate("qoi.decode.estimate"):
                w = _anchored_w(cls, r6, d32, px, entry_px32)
            w = torch.where(starts, w, 0)
            px, exit65, bad, _, _ = round_(w, bad)
            rounds += 1
        return px, starts, npix, pix_off, bad == 0, rounds, exit65


#: offset of the tail slots of the dense records: past every pixel plane,
#: so their deltas land nowhere (qoi_tpu/kernels/expand._INF)
_INF = 0x7FFFFFF0

#: bytes per compaction row of the dense records
_DENSE_SEG = 4096


def scan_inputs(data: torch.Tensor, chunks_len):
    """The one-pass scans' inputs on a padded stream body, as the decode
    gives them: the chunk starts, `_initial_w`'s int32 leaf and npix, and
    `_anchored_w`'s (1, M) int32 leaf from the round-1 px."""
    starts, cls, r6, d32, lit32, npix = _fields(data, chunks_len)
    leaf_w = _initial_leaf(cls, r6, d32, lit32).to(torch.int32)
    px1, *_ = _decode_core(data, chunks_len, max_rounds=1)
    leaf_a = _anch_leaf(cls, r6, d32, px1).to(torch.int32)[None]
    return starts, leaf_w, npix.to(torch.int32), leaf_a


def _chunk_events(starts, pix_off, px32):
    """The (nseg, 4096) rows `_compact_chunks` slides: pix_off and px32 as
    int32 planes, and aux = alive (chunk start) | d << 1 with d = index in
    row - chunk rank in row. Returns (off_r, px_r, aux, base, n_chunks):
    base (nseg,) is each row's first dense record."""
    m = starts.shape[0]
    nseg = m // _DENSE_SEG
    a = starts.to(torch.int64)
    dest = exclusive_cumsum(a)
    n_chunks = dest[-1] + a[-1]
    a_r = a.reshape(nseg, _DENSE_SEG)
    base = exclusive_cumsum(a_r.sum(dim=1))
    iota = torch.arange(_DENSE_SEG, device=starts.device)[None, :]
    d = torch.where(a_r != 0,
                    iota - (dest.reshape(nseg, _DENSE_SEG) - base[:, None]),
                    0)
    aux = (a_r | d << 1).to(torch.int32)
    off_r = pix_off.to(torch.int32).reshape(nseg, _DENSE_SEG)
    px_r = to_i32(px32).reshape(nseg, _DENSE_SEG)
    return off_r, px_r, aux, base, n_chunks


def _compact_chunks(starts, pix_off, px32):
    """Per-byte (pix_off, px32) rows -> chunk-dense records in a prefix of
    the SAME length M (a multiple of 4096). Real records pack at the front
    through the two-plane slide (kernels/slide.slide_val2: the CUDA kernel
    on the card); the rows assemble at their global record offsets in an
    (M + 4096,) buffer (the slide zeroes dead slots, so overlapping
    windows only add zeros); tail slots get (pix_off = _INF, px = 0), so
    their deltas land nowhere and cancel out of every prefix sum. Returns
    (off_d, px_d), (M,) int32 each (px as u32 bit patterns)."""
    m = starts.shape[0]
    off_r, px_r, aux, base, n_chunks = _chunk_events(starts, pix_off, px32)
    off_s, px_s = slide_val2(off_r, px_r, aux)
    tail = torch.arange(m, device=starts.device) >= n_chunks
    off_d = torch.where(tail, _INF, assemble_rows(off_s, base, m))
    px_d = torch.where(tail, 0, assemble_rows(px_s, base, m))
    return off_d, px_d


def _expand_packed(starts, px32, pix_off, n_px_cap: int,
                   dense: bool = False) -> torch.Tensor:
    """Run expansion: out[p] = the px of the last byte with pix_off <= p
    (the seed before the first). `dense` (with M a multiple of
    4096) first compacts the per-byte rows to chunk records
    (`_compact_chunks`); the expand kernel takes either. Returns
    (n_px_cap,) int32."""
    if dense and pix_off.shape[0] % _DENSE_SEG == 0:
        off_d, px_d = _compact_chunks(starts, pix_off, px32)
        return expand_px(off_d, px_d, n_px_cap)
    return expand_px(pix_off.to(torch.int32), to_i32(px32), n_px_cap)


def _decode_device(data: torch.Tensor, chunks_len: int, n_px_cap: int,
                   dense: bool = False, max_rounds: int = _MAX_ROUNDS,
                   apply: str = "vector", surgical: bool = True):
    """Device decode of one padded stream body. `apply` picks pass 3:
    "vector" (the default) or "scan", the numeric re-scan (the
    numeric_scan kernel on the card), which runs without the surgical
    round. Returns (px32 (n_px_cap,) int32, converged, rounds). The span
    `qoi.decode` is the request: every decode span nests in it."""
    with annotate("qoi.decode"):
        px, starts, _, pix_off, conv, rounds, _ = _decode_core(
            data, chunks_len, max_rounds, apply=apply, surgical=surgical)
        with annotate("qoi.decode.expand"):
            out = _expand_packed(starts, px, pix_off, n_px_cap, dense=dense)
        return out, conv, rounds


def decode_group(data: torch.Tensor, chunks_len, n_px_cap: int):
    """Decode same-bucket streams one after another (peak memory stays
    at one stream's), without the surgical round, as the JAX package's
    batched decodes. data: (B, M) uint8; chunks_len: B ints. Returns
    (px32 (B, n_px_cap) int32, converged (B,) bool, rounds (B,) int)."""
    outs, convs, rounds = [], [], []
    for i in range(data.shape[0]):
        out, conv, r = _decode_device(data[i], int(chunks_len[i]), n_px_cap,
                                      surgical=False)
        outs.append(out)
        convs.append(conv)
        rounds.append(r)
    return (torch.stack(outs), torch.tensor(convs, dtype=torch.bool),
            torch.tensor(rounds))


def unpack_px32(px32: np.ndarray) -> np.ndarray:
    """(..., N) 32-bit packed pixels -> (..., N, 4) uint8 rgba."""
    return np.ascontiguousarray(px32).view(np.uint8).reshape(
        px32.shape + (4,))


def decode(data: bytes, channels: int, device, config=None
           ) -> Tuple[np.ndarray, fmt.StreamDesc]:
    """Decode a QOI stream on `device`; pixel-identical to the reference
    decoder (qoi.h:488). A stream whose fixpoint does not converge takes
    `_decode_ladder`. `config` (an EngineConfig) sets the fixpoint cap
    and the shape-bucketing floor."""
    if channels not in (0, 3, 4):
        raise ValueError(f"channels must be 0, 3 or 4, got {channels}")
    desc = fmt.unpack_header(data)
    out_ch = channels if channels else desc.channels
    max_rounds = config.decode_max_iters if config else _MAX_ROUNDS
    floor = config.bucket_floor if config else 256

    chunks = np.frombuffer(data, dtype=np.uint8)[fmt.HEADER_SIZE:]
    chunks_len = len(data) - fmt.HEADER_SIZE - fmt.TRAILER_SIZE
    padded = np.zeros((v1.bucket_size_fine(len(chunks), floor),),
                      np.uint8)
    padded[: len(chunks)] = chunks

    px32, conv, _ = _decode_device(
        torch.from_numpy(padded).to(device), chunks_len,
        v1.bucket_size(desc.num_pixels, floor), max_rounds=max_rounds)
    if not conv:
        return _decode_ladder(data, channels, device)
    img = unpack_px32(px32[: desc.num_pixels].cpu().numpy())[:, :out_ch]
    return img.reshape(desc.height, desc.width, out_ch), desc


def _decode_ladder(data: bytes, channels: int, device):
    """Fallback for fixpoint non-convergence (non-canonical streams: INDEX
    reads of unwritten slots break the table invariant the anchored
    rebuild relies on), in the JAX package's order: the native C++
    decoder (cpp/qoi_oracle.cpp) when it is built, else the v1 decoder on
    `device` (models/decode_pipeline.py, which decodes an INDEX read of
    a never-written slot explicitly and falls back to the sequential
    scan codec, one CUDA kernel on the card, when its own fixpoint does
    not converge)."""
    from .. import oracle

    if oracle.available():
        return oracle.decode(data, channels)
    return v1.decode(data, channels, device)
