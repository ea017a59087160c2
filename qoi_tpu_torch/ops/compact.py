"""Variable-length byte-record compaction (port of
qoi_tpu/ops/compact.py): each pixel yields 0..6 stream bytes, packed
contiguously at the exclusive prefix sum of their lengths.

  * `compact_words6_wordsum` -- the main path's word-sum compaction,
    from packed record words; `compact_bytes6_wordsum` is the same from
    (6, N) byte planes. Both slide their events with kernels/slide.py.
  * `compact_bytes`, `compact_bytes6` -- one stable sort by target
    offset, and its two-tier form (segment sorts + one windowed add)
    over (K, N) byte planes: the encode of `pipeline.encode_device_split`.
  * `compact_bytes_scatter`, `compact_bytes_hybrid`,
    `compact_bytes_merge` -- a scatter, merge doubling + windowed add,
    and log-depth pairwise merging by barrel shifts: differential
    references.

All return (buffer, total) with the same bytes in [0, total) as the JAX
functions, and the same bytes past it wherever the JAX function defines
them.

Every output word of the word-sum compaction is the difference of two
running sums of per-record word contributions, and every word has
exactly one "boundary event" (the record owning its last byte) that
defines its running sum. Events are
built two slots per pixel in (nseg, 2*seg) rows, slid to their dense
within-row positions (kernels/slide.py: the CUDA kernel on the card, its
plain twin on the CPU), placed at global word offsets with one windowed
add, and differenced. See the JAX module for the derivation.

u32 values are int64 in [0, 2**32) here (see _bits); the slide and the
output words are int32 bit patterns.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from .._bits import M32, to_i32, u32
from ..kernels.slide import slide_val
from ..utils.profiling import annotate
from .scans import exclusive_cumsum

#: default pixels per compaction segment (qoi_tpu/ops/compact._COMPACT_SEG)
_COMPACT_SEG = 4096


class WordsumEvents(NamedTuple):
    val: torch.Tensor    # (nseg, sw) int64 u32 event values (0 when dead)
    aux: torch.Tensor    # (nseg, sw) int64 alive bit 0 | distance << 1
    cnt: torch.Tensor    # (nseg,) events per row
    wbase: torch.Tensor  # (nseg,) exclusive cumsum of cnt
    total: torch.Tensor  # 0-d: stream bytes
    v_all: torch.Tensor  # 0-d u32: grand total of all contributions


def assemble_rows(rows: torch.Tensor, r0: torch.Tensor, n: int):
    """Dense per-segment rows (nseg, seg) -> one (n,) plane: row r adds at
    [r0[r], r0[r] + seg) of an (n + seg,) buffer, so no window is
    clipped; dead slots must be 0, so overlapping windows only add zeros.
    The densify (kernels/pack) and the decoder's chunk compaction use it."""
    nseg, seg = rows.shape
    if nseg == 1:
        return rows[0]
    idx = r0[:, None] + torch.arange(seg, device=rows.device)[None, :]
    out = rows.new_zeros(n + seg).index_add_(0, idx.reshape(-1),
                                             rows.reshape(-1))
    return out[:n]


def compact_words6_wordsum(
    lo: torch.Tensor, hi: torch.Tensor, lens: torch.Tensor, capacity: int,
    seg: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Word-sum compaction from packed record words: lo (N,) u32 = record
    bytes 0..3 little-endian, hi (N,) u32 = bytes 4..5, bytes at or past
    lens[i] zero. Returns (words (capacity//4,) int32 -- the stream bytes
    little-endian -- and total 0-d int64).

    HARD CONTRACT: capacity >= total output bytes (sum of lens). The
    windowed add's buffer is sized min(2n, capacity//4) + sw with its
    window starts clamped, and the final-partial-word patch clamps into
    capacity; a capacity below the true total corrupts bytes inside
    capacity instead of truncating. Every caller bounds capacity at the
    format's worst case (6 B/px of per-pixel staging)."""
    if capacity % 4:
        raise ValueError(f"capacity {capacity} is not a multiple of 4")
    with annotate("qoi.encode.compact"):
        ev = wordsum_events(lo, hi, lens, seg)
        val = slide_val(to_i32(ev.val), ev.aux.to(torch.int32))
        return _wordsum_assemble(val, ev.wbase, ev.total, ev.v_all, capacity)


def wordsum_events(lo, hi, lens, seg: int = 0) -> WordsumEvents:
    """The event rows `compact_words6_wordsum` slides: records padded to a
    multiple of the segment with l=0 records (no bytes, no events, zero
    sums -- byte-identical output), then `_wordsum_events_words`."""
    n = lens.shape[0]
    s_eff = seg or _COMPACT_SEG
    if n < s_eff:
        s_eff = n
    elif n % s_eff:
        pad = s_eff - n % s_eff
        lo = torch.cat([lo, lo.new_zeros(pad)])
        hi = torch.cat([hi, hi.new_zeros(pad)])
        lens = torch.cat([lens, lens.new_zeros(pad)])
    return _wordsum_events_words(lo, hi, lens, s_eff)


def _wordsum_events_words(lo_u, hi_u, lens, seg=0) -> WordsumEvents:
    """Per-record word contributions, the N-length cumsums, and the
    2-slots-per-pixel boundary-event list in (nseg, 2*seg) row form."""
    n = lens.shape[0]
    dev = lens.device
    lo_u, hi_u = u32(lo_u), u32(hi_u)
    l = lens.to(torch.int64)
    off = exclusive_cumsum(l)
    total = off[-1] + l[-1]

    s = (off & 3) << 3
    # c1/c2 vanish for records that do not cross a word; (x >> 1) >> (31 - s)
    # is x >> (32 - s) without a shift by 32 at s == 0
    c0 = (lo_u << s) & M32
    c1 = (((lo_u >> 1) >> (31 - s)) | (hi_u << s)) & M32
    c2 = (hi_u >> 1) >> (31 - s)
    vsum = (c0 + c1 + c2) & M32
    vexc = exclusive_cumsum(vsum) & M32
    v_all = (vexc[-1] + vsum[-1]) & M32

    endb = off + l
    w0 = off >> 2
    emits = l > 0
    ev0 = emits & (endb >= (w0 << 2) + 4)      # owns byte 4*w0+3
    ev1 = emits & (endb >= (w0 << 2) + 8)      # owns byte 4*(w0+1)+3
    val0 = (vexc + c0) & M32
    val1 = (vexc + c0 + c1) & M32

    seg = seg or _COMPACT_SEG
    if n % seg or n < seg:
        seg = n
    nseg = n // seg
    sw = 2 * seg

    def rows2(a, b):  # (N,) x2 -> (nseg, 2*seg) in slot order p*2+k
        return torch.stack([a.reshape(nseg, seg), b.reshape(nseg, seg)],
                           dim=2).reshape(nseg, sw)

    val = rows2(torch.where(ev0, val0, 0), torch.where(ev1, val1, 0))
    e0 = ev0.to(torch.int64)
    e1 = ev1.to(torch.int64)
    cnt = (e0 + e1).reshape(nseg, seg).sum(dim=1)
    wbase = exclusive_cumsum(cnt)
    wb = wbase[:, None].expand(nseg, seg).reshape(-1)
    pm = torch.arange(seg, device=dev).repeat(nseg)  # slot pair base / 2
    aux0 = e0 | (torch.where(ev0, 2 * pm - (w0 - wb), 0) << 1)
    aux1 = e1 | (torch.where(ev1, 2 * pm + 1 - (w0 + 1 - wb), 0) << 1)
    return WordsumEvents(val, rows2(aux0, aux1), cnt, wbase, total, v_all)


def _wordsum_assemble(val, wbase, total, v_all, capacity: int):
    """Dense per-segment event rows (int32, dead slots 0) -> global word
    offsets (windowed add), final-partial-word patch, cumsum difference.
    Returns (words (capacity//4,) int32, total)."""
    nseg, sw = val.shape
    n = nseg * sw // 2
    w_cap = capacity // 4
    v = u32(val)
    if nseg == 1:
        cends = v[0]
    else:
        # the rows' windows overlap; dead slots are 0, so adding is exact.
        # Window starts clamp like the JAX scatter's CLIP mode (never
        # engaged under the capacity contract)
        size = min(2 * n, w_cap) + sw
        start = wbase.clamp(0, size - sw)
        idx = (start[:, None]
               + torch.arange(sw, device=val.device)[None, :]).reshape(-1)
        cends = v.new_zeros(size).index_add_(0, idx, v.reshape(-1))
    if w_cap <= cends.shape[0]:
        cends = cends[:w_cap]
    else:
        cends = torch.cat([cends, cends.new_zeros(w_cap - cends.shape[0])])
    cends = cends & M32

    # a final partial word (total % 4 != 0) has no boundary event: its
    # running sum is the grand total. total == 0 clamps to word 0 (whose
    # value is 0 == v_all), as the JAX dynamic_update_slice clamps
    w_last = ((total - 1) >> 2).clamp(min=0).reshape(1)
    cends = cends.scatter(0, w_last, v_all.reshape(1))

    words = (cends - torch.cat([cends.new_zeros(1), cends[:-1]])) & M32
    return to_i32(words), total


def compact_bytes6_wordsum(
    staging6: torch.Tensor, lens: torch.Tensor, capacity: int,
    seg: int = 0, words_out: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """`compact_words6_wordsum` from (6, N) uint8 byte planes: the
    records' bytes packed to (lo, hi) words (kernels/pack._record_words),
    then the same events, slide and assembly. Returns (buffer (capacity,)
    uint8, or with `words_out` the (capacity//4,) int32 words, and total).
    The JAX function makes a ragged N one segment; the port pads it with
    l=0 records (`wordsum_events`), which gives the same bytes and keeps
    the slide rows within the kernel's width."""
    from ..kernels.pack import _record_words

    lo, hl = _record_words(staging6, lens)
    words, total = compact_words6_wordsum(lo, hl & 0xFFFF, lens, capacity,
                                          seg=seg)
    return (words if words_out else words.view(torch.uint8)), total


def _fit(buf: torch.Tensor, capacity: int) -> torch.Tensor:
    """The first `capacity` entries of buf, zero-extended past its end."""
    if capacity <= buf.shape[0]:
        return buf[:capacity]
    return torch.cat([buf, buf.new_zeros(capacity - buf.shape[0])])


def _total(lens: torch.Tensor) -> torch.Tensor:
    return lens.to(torch.int64).sum()


def compact_bytes(staging: torch.Tensor, lens: torch.Tensor,
                  capacity: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sort-based compaction. staging: (N, K) uint8; lens: (N,) with
    lens[i] <= K; capacity: output size. Each staged byte is keyed by its
    target offset (invalid bytes by N*K) and one stable sort orders them,
    so the invalid bytes follow the stream in staging order, as after the
    JAX stable `sort_key_val`."""
    n, k = staging.shape
    offs = exclusive_cumsum(lens)
    col = torch.arange(k, device=staging.device)[None, :]
    tgt = torch.where(col < lens[:, None], offs[:, None] + col, n * k)
    order = torch.sort(tgt.reshape(-1), stable=True).indices
    return _fit(staging.reshape(-1)[order], capacity), _total(lens)


#: pixels per segment of `compact_bytes6`'s first tier
_BYTES6_SEG = 4096


def compact_bytes6(staging6: torch.Tensor, lens: torch.Tensor,
                   capacity: int, seg: int = 0
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Two-tier sort compaction over (K, N) uint8 byte planes.

    Tier 1: each `seg`-pixel segment sorts its staged bytes by (offset
    within the segment << 8 | byte): a pixel's bytes never leave its
    segment's output range, so the local sorts are globally right, and
    invalid bytes (keyed past the segment) sort last and are zeroed.
    Tier 2: the segment rows add into the output at their global
    offsets; overlapping windows only add zeros onto real bytes.
    N not a multiple of seg, or below two segments: one global stable
    sort, as `compact_bytes` over the plane-major order."""
    k, n = staging6.shape
    dev = staging6.device
    offs = exclusive_cumsum(lens)
    col = torch.arange(k, device=dev)[:, None]
    valid = col < lens[None, :]
    seg = seg or _BYTES6_SEG
    if n % seg or n < 2 * seg:
        tgt = torch.where(valid, offs[None, :] + col, n * k).reshape(-1)
        order = torch.sort(tgt, stable=True).indices
        packed = staging6.reshape(-1)[order]
    else:
        nseg = n // seg
        w = seg * k
        seg_off = offs.reshape(nseg, seg)[:, 0]
        loc_off = offs - seg_off.repeat_interleave(seg)
        key = torch.where(valid, loc_off[None, :] + col, w)
        rows = ((key << 8) | staging6.to(torch.int64)).reshape(
            k, nseg, seg).transpose(0, 1).reshape(nseg, w)
        srt = torch.sort(rows, dim=1).values
        seg_bytes = torch.where((srt >> 8) < w, srt & 0xFF, 0).to(torch.int32)
        idx = seg_off[:, None] + torch.arange(w, device=dev)[None, :]
        packed = torch.zeros(n * k + w, dtype=torch.int32, device=dev)
        packed = packed.index_add_(0, idx.reshape(-1), seg_bytes.reshape(-1))
        packed = packed.to(torch.uint8)
    return _fit(packed, capacity), _total(lens)


def compact_bytes_scatter(staging: torch.Tensor, lens: torch.Tensor,
                          capacity: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Scatter compaction, the differential baseline: every valid byte to
    its offset, bytes at or past `capacity` dropped."""
    n, k = staging.shape
    offs = exclusive_cumsum(lens)
    col = torch.arange(k, device=staging.device)[None, :]
    pos = offs[:, None] + col
    keep = ((col < lens[:, None]) & (pos < capacity)).reshape(-1)
    out = staging.new_zeros(capacity + 1)
    # dropped bytes land in the spare last entry
    out[torch.where(keep, pos.reshape(-1), capacity)] = staging.reshape(-1)
    return out[:capacity], _total(lens)


def _barrel_shift_right(x: torch.Tensor, shift: torch.Tensor,
                        max_shift: int) -> torch.Tensor:
    """Per-row right shift of byte rows by shift[r] in [0, max_shift], as
    rolls selected by the bits of the shift; vacated bytes are zero and
    bytes shifted past the row's end are dropped. x: (R, W) uint8."""
    w = x.shape[-1]
    keep_from = torch.arange(w, device=x.device)[None, :]
    bit = 1
    while bit <= max_shift and bit < w:
        rolled = torch.where(keep_from >= bit, torch.roll(x, bit, dims=-1), 0)
        x = torch.where(((shift & bit) != 0)[:, None], rolled, x)
        bit <<= 1
    return x


def _merge_pairs(data: torch.Tensor, cur: torch.Tensor):
    """One merge level: rows 2i and 2i+1 concatenate into one row twice as
    wide (the second barrel-shifted past the first's length); an odd last
    row rides along unpaired."""
    rows, width = data.shape
    half = rows // 2
    pad = (0, width)
    first = torch.nn.functional.pad(data[0:2 * half:2], pad)
    second = torch.nn.functional.pad(data[1:2 * half:2], pad)
    len1, len2 = cur[0:2 * half:2], cur[1:2 * half:2]
    merged = first | _barrel_shift_right(second, len1, max_shift=width)
    merged_len = len1 + len2
    if rows % 2:
        merged = torch.cat([merged, torch.nn.functional.pad(data[-1:], pad)])
        merged_len = torch.cat([merged_len, cur[-1:]])
    return merged, merged_len


def _zero_tails(staging: torch.Tensor, lens: torch.Tensor):
    col = torch.arange(staging.shape[1], device=staging.device)[None, :]
    return (torch.where(col < lens[:, None], staging, 0),
            lens.to(torch.int64))


def compact_bytes_hybrid(staging: torch.Tensor, lens: torch.Tensor,
                         capacity: int, width_stop: int = 3072
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Merge doubling up to `width_stop`-byte records, then one windowed
    add at the records' offsets (window starts clamped to [0, capacity],
    as the JAX scatter's CLIP mode): a merged record's tail is zero, so
    overlapping windows only add zeros onto real bytes."""
    data, cur = _zero_tails(staging, lens)
    while data.shape[1] < width_stop and data.shape[0] > 1:
        data, cur = _merge_pairs(data, cur)
    rows, width = data.shape
    start = exclusive_cumsum(cur).clamp(0, capacity)
    idx = start[:, None] + torch.arange(width, device=data.device)[None, :]
    out = torch.zeros(capacity + width, dtype=torch.int32, device=data.device)
    out = out.index_add_(0, idx.reshape(-1),
                         data.reshape(-1).to(torch.int32))
    return (out[:capacity] & 0xFF).to(torch.uint8), cur.sum()


def compact_bytes_merge(staging: torch.Tensor, lens: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Compaction by log-depth pairwise merging of records, scatter-free.
    staging: (N, K) uint8 with lens[i] valid leading bytes in row i.
    Returns (flat row of the final width with the stream in [0, total),
    total)."""
    data, cur = _zero_tails(staging, lens)
    while data.shape[0] > 1:
        data, cur = _merge_pairs(data, cur)
    return data[0], cur[0]
