"""Record pack, the splitd encode compaction: CUDA kernel `csrc/pack.cu` for
the word placement, its plain twin, and the plain PyTorch steps around it
(port of qoi_tpu/kernels/pack.py).

  densify   emitting pixels -> dense records (`_densify_shift`, or the
            sort `_densify_sort` kept as its differential reference)
  prep      per-record word position and contributions (`_prep_planes`)
  place     word-granular placement (`place_words`: the kernel on the
            card, two index_add_ on the CPU)

Word decomposition: a record of len <= 6 bytes at byte offset o spans at
most the words w = o >> 2, w+1, w+2. With s = (o & 3) * 8 and the
record's bytes packed little-endian into lo (bytes 0-3) and hi (bytes
4-5), its contributions are

    c0 = lo << s
    c1 = (lo >> (32 - s)) | (hi << s)      (s = 0: hi)
    c2 =  hi >> (32 - s)                   (nonzero only at s = 24, len 6)

Every output byte is owned by exactly one record, so adding contributions
is carry-free and exact. u32 values are int64 in [0, 2**32) in the plain
steps (see _bits); the kernel takes int32 bit patterns.
"""
from __future__ import annotations

import torch

from .._bits import M32, to_i32
from ..ops.compact import assemble_rows
from ..ops.scans import exclusive_cumsum
from . import _build

#: pixels per densify segment: caps the slide distance at 12 bits, so it
#: packs into bits 19..30 of the hl word
_DENSIFY_SEG = 4096


def _record_words(staging6: torch.Tensor, lens: torch.Tensor):
    """Each pixel's staged bytes -> (lo, hl = hi | len << 16), int64, with
    bytes at or past len masked to zero (the staging contract covers only
    bytes < len). staging6: (6, N) uint8; lens: (N,)."""
    if staging6.dim() != 2 or staging6.shape[0] != 6:
        raise ValueError(f"staging6: shape {tuple(staging6.shape)}, "
                         "want (6, N)")
    st = staging6.to(torch.int64)
    lo = st[0] | st[1] << 8 | st[2] << 16 | st[3] << 24
    hi = st[4] | st[5] << 8
    l = lens.to(torch.int64)
    m0 = torch.where(l >= 4, M32, (1 << (l.clamp(max=3) << 3)) - 1)
    m1 = torch.where(l >= 6, 0xFFFF, torch.where(l == 5, 0xFF, 0))
    return lo & m0, (hi & m1) | l << 16


def _densify_sort(staging6: torch.Tensor, lens: torch.Tensor):
    """Emitting pixels -> dense records by ONE stable sort on the running
    emitter count. Returns (off, lo, hi, len), each (N,) int64: byte
    offset, bytes 0-3 packed LE, bytes 4-5, length; tail records (past
    the emitter count) have len 0 and off == total. The differential
    reference for `_densify_shift`."""
    n = lens.shape[0]
    lo, hl = _record_words(staging6, lens)
    valid = lens > 0
    key = torch.where(valid, exclusive_cumsum(valid), n)
    order = torch.sort(key, stable=True).indices
    lo_d, hl_d = lo[order], hl[order]
    len_d = (hl_d >> 16) & 7
    return exclusive_cumsum(len_d), lo_d, hl_d & 0xFFFF, len_d


def _densify_shift(staging6: torch.Tensor, lens: torch.Tensor):
    """Emitting pixels -> dense records by log-distance shift passes, no
    sort. Densifying never reorders records: it slides each valid record
    left by d = the count of empty slots before it in its segment, and
    sliding by d's bits LSB-first is collision-free (the JAX docstring
    has the proof). d < seg <= 4096 rides in hl bits 19..30, so each of
    the 12 passes is a static shift and a select on two planes. A slot
    whose record moves out is killed (len bits zeroed) unless a mover
    lands on it. The per-segment dense rows then assemble at their
    global record offsets. Returns (off, lo, hi, len) as `_densify_sort`.
    """
    n = lens.shape[0]
    seg = _DENSIFY_SEG      # an N that is not a multiple is one segment
    if n % seg or n < seg:
        seg = n
    if seg > 1 << 12:
        raise ValueError(f"densify segment {seg} > 4096: d must fit hl "
                         "bits 19..30; pad N to a multiple of 4096")
    nseg = n // seg

    lo, hl = _record_words(staging6, lens)
    valid = (lens > 0).to(torch.int64).reshape(nseg, seg)
    d = exclusive_cumsum(1 - valid)
    lo = lo.reshape(nseg, seg)
    hl = hl.reshape(nseg, seg) | d << 19
    lenm = 0x70000

    def shift_rows(x, k):
        return torch.cat([x[:, k:], x.new_zeros((nseg, k))], dim=1)

    bit = 1
    while bit < seg:
        lo_s, hl_s = shift_rows(lo, bit), shift_rows(hl, bit)
        dbit = bit << 19
        mv_in = ((hl_s & dbit) != 0) & ((hl_s & lenm) != 0)
        mv_out = ((hl & dbit) != 0) & ((hl & lenm) != 0)
        lo = torch.where(mv_in, lo_s, lo)
        hl = torch.where(mv_in, hl_s, torch.where(mv_out, 0, hl))
        bit <<= 1

    # zero dead slots in BOTH planes so overlapping windows add zeros
    hl = hl & 0x7FFFF
    cnt = valid.sum(dim=1)
    real = torch.arange(seg, device=lens.device)[None, :] < cnt[:, None]
    lo = torch.where(real, lo, 0)
    hl = torch.where(real, hl, 0)
    r0 = exclusive_cumsum(cnt)
    lo_d = assemble_rows(lo, r0, n)
    hl_d = assemble_rows(hl, r0, n)
    len_d = (hl_d >> 16) & 7
    return exclusive_cumsum(len_d), lo_d, hl_d & 0xFFFF, len_d


def _prep_planes(off_d, lo_d, hi_d, total):
    """Word position + contribution planes (R = N + 1,) int64 from dense
    records. Tail records (len 0, contributions 0) land at wp = total >> 2.
    The rare third-word spill (s = 24, len 6) folds into the NEXT record's
    c0: that record starts at off + 6, so its word is exactly wp + 2, and
    the spilled byte is that word's byte 0, which the next record never
    owns. One sentinel slot at wp = total >> 2 catches a spill from the
    final record when every pixel emitted."""
    s = (off_d & 3) << 3
    # (x >> 1) >> (31 - s) is x >> (32 - s) without a shift by 32 at s == 0
    c0 = (lo_d << s) & M32
    c1 = (((lo_d >> 1) >> (31 - s)) | (hi_d << s)) & M32
    c2 = (hi_d >> 1) >> (31 - s)
    total = torch.as_tensor(total, dtype=torch.int64, device=off_d.device)
    wp = torch.cat([off_d >> 2, (total >> 2).reshape(1)])
    c0 = torch.cat([c0[:1], c0[1:] | c2[:-1], c2[-1:]])
    c1 = torch.cat([c1, c1.new_zeros(1)])
    return wp, c0, c1


def place_words_plain(wp: torch.Tensor, c0: torch.Tensor, c1: torch.Tensor,
                      w_cap: int) -> torch.Tensor:
    """Plain PyTorch twin of the placement: two index_add_ of the
    contributions (c0 at word wp, c1 at wp + 1; words >= w_cap dropped)
    into a zeroed (w_cap,) int64, masked to 32 bits. Returns int32."""
    out = torch.zeros(w_cap, dtype=torch.int64, device=wp.device)
    w = wp.to(torch.int64)
    for at, c in ((w, c0), (w + 1, c1)):
        keep = (at >= 0) & (at < w_cap)
        out.index_add_(0, at[keep], c.to(torch.int64)[keep] & M32)
    return to_i32(out & M32)


def place_words(wp: torch.Tensor, c0: torch.Tensor, c1: torch.Tensor,
                w_cap: int) -> torch.Tensor:
    """Scatter word contributions to their word positions: (w_cap,) int32
    stream words, 0 past the stream. wp: (R,) int32 record words; c0, c1:
    (R,) int32 bit patterns added at words wp and wp + 1. CPU tensors
    take the plain twin; CUDA tensors launch the kernel (or raise)."""
    if not (wp.shape == c0.shape == c1.shape) or wp.dim() != 1:
        raise ValueError(f"place_words: shapes {tuple(wp.shape)}, "
                         f"{tuple(c0.shape)} and {tuple(c1.shape)}, want "
                         "three equal (R,)")
    if all(t.device.type == "cpu" for t in (wp, c0, c1)):
        return place_words_plain(wp, c0, c1, w_cap)
    _build.check_cuda("place_words", wp, c0, c1)
    out = torch.zeros(w_cap, dtype=torch.int32, device=wp.device)
    if wp.numel() == 0 or w_cap == 0:
        return out
    with torch.cuda.device(wp.device):
        rc = _build.lib().qoi_place_words(
            wp.data_ptr(), c0.data_ptr(), c1.data_ptr(), out.data_ptr(),
            wp.numel(), w_cap, _build.stream_ptr(wp.device))
    _build.launched("place_words", rc)
    return out


def densify_records(staging6: torch.Tensor, lens: torch.Tensor):
    """Program A's tail of the splitd encode: emitting pixels -> dense
    records. staging6: (6, N) uint8; lens: (N,). Returns (off_d, lo_d,
    hi_d, total) for `place_records`."""
    off_d, lo_d, hi_d, _ = _densify_shift(staging6, lens)
    return off_d, lo_d, hi_d, lens.to(torch.int64).sum()


def place_records(off_d, lo_d, hi_d, total, capacity: int):
    """Program B of the splitd encode: plane prep + the placement, from
    `densify_records`' outputs. Returns (buffer (capacity,) uint8, the
    stream in [0, total) and 0 after it, total)."""
    if capacity % 4:
        raise ValueError(f"capacity {capacity} is not a multiple of 4")
    wp, c0, c1 = _prep_planes(off_d, lo_d, hi_d, total)
    words = place_words(wp.to(torch.int32), to_i32(c0), to_i32(c1),
                        capacity // 4)
    return words.view(torch.uint8), total


def compact_bytes6_pack(staging6: torch.Tensor, lens: torch.Tensor,
                        capacity: int, *, densify: str = "shift"):
    """Byte-plane staging -> stream bytes through the record pack.
    staging6: (6, N) uint8; lens: (N,) in [0, 6]; capacity: output bytes,
    a multiple of 4 and at least sum(lens). Returns (buffer (capacity,)
    uint8, the stream in [0, total) and 0 after it, total 0-d int64)."""
    dense = {"shift": _densify_shift, "sort": _densify_sort}[densify]
    off_d, lo_d, hi_d, _ = dense(staging6, lens)
    return place_records(off_d, lo_d, hi_d,
                         lens.to(torch.int64).sum(), capacity)
