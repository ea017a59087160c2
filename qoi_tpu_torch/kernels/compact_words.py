"""Word compaction of the encode's records: CUDA kernel
`csrc/compact_words.cu` and its plain twin.

The card route of `ops/compact.compact_words6_wordsum`, whose CPU route
(the word-sum events, the slide and the windowed add) is the port of
qoi_tpu/ops/compact.py. lo, hi, lens (N,): a record's bytes 0..3
little-endian, bytes 4..5 and its length 0..6, as int32 bit patterns (the
staging kernel's outputs) or int64 u32 values. Returns (words
(capacity // 4,) int32, total 0-d int64) equal to the word-sum route's
word for word: the stream's bytes little-endian in words
[0, ceil(total / 4)), then (-sum of those words) mod 2**32 when that word
lies inside capacity, then zeros.

On the card one launch runs over tiles of `TILE` records: each tile's
byte count, its offset by a look-back over the tiles before it, its words
assembled in shared memory, the words it shares with its neighbours ORed
into the zeroed output, and the trailing word from the sum of every
tile's words. `compact_words_plain` repeats that tile arithmetic.
"""
from __future__ import annotations

from typing import Tuple

import torch

from .._bits import M32, to_i32, u32
from ..ops.scans import exclusive_cumsum
from . import _build

#: records a tile (csrc/compact_words.cu kTile)
TILE = 4096
#: the scratch's leading words: the ticket, the done counter, the word sum
#: and the total; a status word a tile follows (csrc/compact_words.cu kHead)
_HEAD = 4


def _check(lo, hi, lens, capacity: int) -> int:
    if capacity % 4:
        raise ValueError(f"capacity {capacity} is not a multiple of 4")
    if lens.dim() != 1 or lo.shape != lens.shape or hi.shape != lens.shape:
        raise ValueError(f"compact_words: shapes {tuple(lo.shape)}, "
                         f"{tuple(hi.shape)} and {tuple(lens.shape)}, want "
                         "three equal (N,)")
    n = lens.shape[0]
    if 6 * n >= 1 << 32:
        raise ValueError(f"compact_words: {n} records, want 6N < 2**32")
    return n


def compact_words_plain(lo: torch.Tensor, hi: torch.Tensor,
                        lens: torch.Tensor, capacity: int,
                        tile: int = TILE
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch twin of the kernel, tile by tile as the kernel works
    (`tile` records a tile): the tiles' byte counts, their exclusive
    offsets, each tile's words at its offset's alignment, the words of
    the stream (a word two or more tiles share is the OR of their parts,
    added here: their bytes are disjoint), and the trailing word from
    the sum of every tile's words. Lengths are taken at most 6 and bytes
    past a length masked off, as the kernel does."""
    n = _check(lo, hi, lens, capacity)
    dev = lens.device
    w_cap = capacity // 4
    out = torch.zeros(w_cap, dtype=torch.int64, device=dev)
    if n == 0:
        return to_i32(out), torch.zeros((), dtype=torch.int64, device=dev)
    tiles = -(-n // tile)
    pad = tiles * tile - n

    def rows(x):
        return torch.cat([x, x.new_zeros(pad)]).reshape(tiles, tile)

    l = rows(lens.to(torch.int64).clamp(0, 6))
    lo_m = rows(u32(lo)) & torch.where(l >= 4, M32, (1 << (8 * l)) - 1)
    hi_m = rows(u32(hi)) & ((1 << (8 * (l - 4).clamp(min=0))) - 1)

    t_bytes = l.sum(dim=1)                              # a tile's T
    e = exclusive_cumsum(t_bytes)                       # its offset E
    total = e[-1] + t_bytes[-1]
    pos = e[:, None] + exclusive_cumsum(l)              # a record's byte

    # each tile's words: word 0 is global word E >> 2; a record's six
    # bytes at shift s reach three words (c0, c1, c2 as in ops/compact)
    s = (pos & 3) << 3
    c0 = (lo_m << s) & M32
    c1 = (((lo_m >> 1) >> (31 - s)) | (hi_m << s)) & M32
    c2 = (hi_m >> 1) >> (31 - s)
    width = tile * 6 // 4 + 3
    idx = (pos >> 2) - (e >> 2)[:, None] \
        + (torch.arange(tiles, device=dev) * width)[:, None]
    tw = torch.zeros(tiles * width, dtype=torch.int64, device=dev)
    for k, c in enumerate((c0, c1, c2)):
        tw.index_add_(0, (idx + k).reshape(-1), c.reshape(-1))
    tw = tw.reshape(tiles, width)

    # the tile's words [E >> 2, ceil(I / 4)): the partial ones OR (add)
    # into the output, the whole ones are stored
    i_end = e + t_bytes
    g = (e >> 2)[:, None] + torch.arange(width, device=dev)[None, :]
    used = (g < ((i_end + 3) >> 2)[:, None]) & (t_bytes > 0)[:, None]
    shared = used & (((g == (e >> 2)[:, None]) & (e & 3 != 0)[:, None])
                     | ((g == (i_end >> 2)[:, None])
                        & (i_end & 3 != 0)[:, None]))
    keep = used & (g < w_cap)
    whole = keep & ~shared
    out[g[whole]] = tw[whole]
    out.index_add_(0, g[keep & shared], tw[keep & shared])

    word_sum = (tw * used).sum() & M32
    w_t = int((total + 3) >> 2)
    if w_t < w_cap:
        out[w_t] = (-word_sum) & M32
    return to_i32(out), total


def _i32(x: torch.Tensor) -> torch.Tensor:
    """A record plane as the kernel takes it: int32 bit patterns as they
    are, any other integer dtype narrowed from its u32 value."""
    return x.contiguous() if x.dtype == torch.int32 else to_i32(u32(x))


def compact_words(lo: torch.Tensor, hi: torch.Tensor, lens: torch.Tensor,
                  capacity: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The records' stream as (capacity // 4,) int32 words and its total
    (0-d int64, left on the device). CPU tensors take the plain twin;
    CUDA tensors launch the kernel (or raise). Raises ValueError for a
    capacity that is not a multiple of 4."""
    n = _check(lo, hi, lens, capacity)
    if all(t.device.type == "cpu" for t in (lo, hi, lens)):
        return compact_words_plain(lo, hi, lens, capacity)
    lo, hi, lens = _i32(lo), _i32(hi), _i32(lens)
    _build.check_cuda("compact_words", lo, hi, lens)
    dev = lens.device
    out = torch.empty(capacity // 4, dtype=torch.int32, device=dev)
    total = torch.empty((), dtype=torch.int64, device=dev)
    if n == 0:
        out.zero_()
        total.zero_()
        return out, total
    scratch = torch.empty(_HEAD + -(-n // TILE), dtype=torch.int64,
                          device=dev)
    with torch.cuda.device(dev):
        rc = _build.lib().qoi_compact_words(
            lo.data_ptr(), hi.data_ptr(), lens.data_ptr(), n,
            out.data_ptr(), capacity // 4, total.data_ptr(),
            scratch.data_ptr(), _build.stream_ptr(dev))
    _build.launched("compact_words", rc)
    return out, total
