"""Sequence-parallel encode: ONE stream, its pixels tiled over the "seq"
axis of a mesh (port of qoi_tpu/parallel/tiled.py, on torch.distributed).

Every rank of the seq axis owns a contiguous tile of the pixel stream.
The reference encoder's four loop carries (qoi.h:406-478) cross the tile
boundaries as small summaries:

  px_prev   -- each tile's last pixel, in the packed summary
  run       -- the pending-run phase (mod 62), composed over the S tiles'
               (all_eq, trail) summaries
  index[64] -- each tile's last writer of every slot, combined by the
               overwrite monoid
  cursor    -- the tiles' byte totals, exclusive-summed into offsets

Phase A computes the local summaries and ONE all_gather of a 132-word
summary per tile exchanges every carry at once (boundary pixel
included). Every rank then composes the S summaries (a few Python steps
on the host: S is the rank count). Phase B re-runs the data-parallel
stages with the exact incoming state (models/pipeline
`encode_stage_chunks`) and compacts the tile with the main path's
word-sum compaction (ops/compact `compact_words6_wordsum`, the
compact_words kernel on the card). A second all_gather exchanges the byte
totals, which exist only after phase B. The stream is byte-identical to
the reference encoder's. The JAX package returns the tiles' bytes to its
one controller; here every rank gathers them (a third all_gather) and
returns the whole stream.
"""
from __future__ import annotations

from typing import List, NamedTuple, Tuple

import numpy as np
import torch

from .. import format as fmt
from ..models import pipeline
from ..ops import compact, table
from . import sharding

#: pixels per row of the tile's word-sum compaction (the main path's)
_SEG = 20480
_SLOT53 = fmt.hash_rgba(*fmt.SEED_PIXEL)
_SEED_W = (fmt.SEED_PIXEL[0] | fmt.SEED_PIXEL[1] << 8
           | fmt.SEED_PIXEL[2] << 16 | fmt.SEED_PIXEL[3] << 24)


class TileOut(NamedTuple):
    """One tile's encode: its bytes (buf[:total]), total and stream
    offset (the JAX tile step's three outputs), and every tile's total."""

    buf: torch.Tensor      # (6B,) uint8, the tile's bytes in [0, total)
    total: int
    offset: int
    totals: List[int]


def _summary(px4: torch.Tensor, n_valid: int) -> torch.Tensor:
    """Phase A: the tile's 132-word summary (int64 u32 values), computed
    against a SEED incoming pixel. [0] last pixel (packed); [1] all_eq |
    trail << 1; [2:66] last written value of each slot; [66:130] written
    flags; [130] first pixel (packed); [131] whether the tile has a pixel.
    Only local position 0's eq bit depends on the true boundary pixel,
    and the compose re-derives it from the gathered first/last words."""
    b = px4.shape[0]
    dev = px4.device
    io = torch.arange(b, device=dev)
    seed = torch.tensor(fmt.SEED_PIXEL, dtype=torch.uint8, device=dev)
    prev = torch.cat([seed[None], px4[:-1]])
    eq = (px4 == prev).all(dim=-1) | (io >= n_valid)
    packed = table.pack_rgba(px4)
    # each slot's last writer (a non-eq pixel): the table's block-local
    # phase with the tile as one block
    _, _, wr, tbl = table.table_hit_local(table.hash64(px4), packed, ~eq, b)
    last_noneq = torch.where(eq, -1, io).max()
    trail = (b - 1) - last_noneq          # trailing run (when not all eq)
    return torch.cat([
        packed[-1:], ((last_noneq < 0).to(torch.int64) | trail << 1)[None],
        tbl[0], wr[0].to(torch.int64), packed[:1],
        torch.tensor([int(n_valid > 0)], device=dev)])


def _compose(rows: List[List[int]], b: int, index: int):
    """The replicated compose of the gathered summaries: this tile's
    incoming pixel word, pending run and table (values, written flags)."""
    lasts = [r[0] for r in rows]
    firsts = [r[130] for r in rows]
    prevs = [_SEED_W] + lasts[:-1]
    # the true position-0 eq bit of every tile (tile 0: against the seed,
    # the bit phase A assumed)
    eq0s = [f == p for f, p in zip(firsts, prevs)]

    # pending-run phase: positions >= 1 are prev-independent, so
    # "positions >= 1 all eq" == all_eq | (trail == b - 1), and the tile
    # is all-eq iff that holds and its position 0 is eq too
    run, run_in = 0, 0
    for i, r in enumerate(rows):
        if i == index:
            run_in = run
        all_eq, trail, have = r[1] & 1, r[1] >> 1, r[131]
        tail_eq = all_eq or trail == b - 1
        if tail_eq and (eq0s[i] or not have):   # pad tiles stay all-eq
            run = (run + b) % fmt.RUN_CAP
        else:
            run = (b - 1 if tail_eq else trail) % fmt.RUN_CAP

    # table: exclusive overwrite-combine, with the position-0 write
    # corrected. Phase A took position 0 against the seed, so per tile:
    #  * a spurious write (first != seed, first == prev): phase A wrote
    #    (hash(first) -> first) where the encoder writes nothing. Safe: eq
    #    at 0 means an earlier tile's write already put `first` there.
    #  * a missed write (first == seed, first != prev): the encoder writes
    #    the seed at slot 53 before any other write of the tile; patch it
    #    in unless a later local write to slot 53 shadows it.
    tbl, wr = [0] * 64, [False] * 64
    for i in range(index):
        r = rows[i]
        t, w = r[2:66], [x != 0 for x in r[66:130]]
        if firsts[i] == _SEED_W and not eq0s[i] and r[131] and not w[_SLOT53]:
            t[_SLOT53], w[_SLOT53] = _SEED_W, True
        tbl = [tv if wv else cv for tv, wv, cv in zip(t, w, tbl)]
        wr = [a or c for a, c in zip(w, wr)]
    return prevs[index], run_in, (tbl, wr)


def _tile_step(px4: torch.Tensor, n_total: int,
               ax: "sharding.Axis") -> TileOut:
    """One tile of the encode on this rank. px4: (B, 4) uint8, this rank's
    tile (pixels past the stream's end are zero); n_total: the stream's
    pixel count; ax: the seq axis."""
    b = px4.shape[0]
    dev = px4.device
    st = ax.stats
    n_valid = min(max(n_total - ax.index * b, 0), b)  # pad tiles emit nothing
    with st.phase("encode phase A", dev):
        summary = _summary(px4, n_valid)
    rows = ax.all_gather(summary).cpu().tolist()          # (S, 132)
    with st.phase("encode phase B", dev):
        prev_w, run_in, (tbl, wr) = _compose(rows, b, ax.index)
        prev_in = torch.tensor([(prev_w >> (8 * k)) & 0xFF for k in range(4)],
                               dtype=torch.uint8, device=dev)
        ch = pipeline.encode_stage_chunks(
            px4, n_valid, prev_in=prev_in, run_in=run_in,
            table_in=(torch.tensor(tbl, dtype=torch.int64, device=dev),
                      torch.tensor(wr, device=dev)),
            contains_last=(n_total - 1) // b == ax.index)
        cap = -(-6 * b // 4) * 4
        words, total = compact.compact_words6_wordsum(
            ch.lo, ch.hi, ch.lens, cap, seg=_SEG)
        buf = words.view(torch.uint8)[:6 * b]
    totals = ax.all_gather(total.reshape(1)).reshape(-1).tolist()
    return TileOut(buf, totals[ax.index], sum(totals[:ax.index]), totals)


def shard_pixels(pixels: np.ndarray, desc: fmt.StreamDesc,
                 ax: "sharding.Axis", device) -> Tuple[torch.Tensor, int]:
    """This rank's tile of an image's pixels: ((B, 4) uint8 on `device`,
    zero past the stream's end, and the pixel count), with B =
    max(ceil(N/S), 2) -- a 1-pixel tile would break the px4[:-1] shift."""
    px4 = pipeline.force_rgba(pixels, desc)
    n = px4.shape[0]
    b = max(-(-n // ax.size), 2)
    tile = np.zeros((b, 4), np.uint8)
    mine = px4[ax.index * b:(ax.index + 1) * b]
    tile[:len(mine)] = mine
    return torch.from_numpy(tile).to(device), n


def encode_tiled(pixels: np.ndarray, desc: fmt.StreamDesc,
                 mesh: "sharding.Mesh", device="cuda") -> bytes:
    """Encode one image as a single stream, its pixels tiled over the seq
    axis of `mesh`; byte-identical to the reference encoder (qoi.h:356).
    Every rank of the axis calls it with the same image and returns the
    whole stream. `device`: this rank's device (a bare "cuda" is the card
    rank % device_count)."""
    desc.validate()
    ax = mesh.seq
    tile, n = shard_pixels(pixels, desc, ax, sharding.rank_device(device))
    out = _tile_step(tile, n, ax)
    # every rank's bytes, each tile's buffer cut to the longest total,
    # gathered to the host, where the stream goes
    width = max(out.totals)
    bufs = ax.gather_to_host(out.buf[:width]).numpy()
    body = b"".join(bufs[i, :t].tobytes() for i, t in enumerate(out.totals))
    return fmt.pack_header(desc) + body + fmt.TRAILER
