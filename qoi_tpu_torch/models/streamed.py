"""Streamed encode and decode for images of any size the format allows
(port of qoi_tpu/models/streamed.py).

The reference caps images at 400M pixels (qoi.h:329-332): ~1.6 GB of RGBA
input and up to 2 GB of stream. Both directions here walk the image in
fixed-size tiles on one device and chain the codec's state from tile to
tile, so device memory stays O(stream + tile) and the output is
byte-identical (encode) or pixel-identical (decode) to the reference.

Encode chains the four encoder carries (`pipeline.EncoderCarry`: boundary
pixel, pending run, 64-slot table) through `encode_stage_chunks` and
compacts each tile with the word-sum compaction (the slide_val kernel).
Decode ends each byte tile at a chunk boundary, runs the fixpoint decoder
(`decode_v3._decode_core`) from the previous tile's exit state, and
expands the tile's pixels with its entry px as the seed; a tile that does
not converge is decoded by the sequential scan (models/scan_codec.py)
from the same entry state.

The JAX package keeps the cursors on the TPU and never syncs between
tiles, because of that machine's slow host link. Here the host reads a
few numbers a tile (the byte total, the tile end), as the fixpoint
already reads its mismatch count once a round, and the cursors are Python
ints: no offset is limited to 32 bits.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .. import format as fmt
from .._bits import to_i32, u32
from ..kernels.expand import _SEED32, expand_px
from ..ops import compact, fsm
from ..ops.scans import exclusive_cumsum
from . import decode_v3, pipeline, scan_codec
from .buckets import bucket_size

#: tiles uploaded ahead of the one being encoded
_DEPTH = 2


def _encode_capacity(n: int, t: int) -> int:
    """Bytes of the device stream buffer for n pixels in tiles of t. The
    stream's true worst case is 5 B/px (chunks partition the pixels, each
    covers >= 1 px in <= 5 bytes; a pending run carried across tiles only
    defers its byte), so the bytes before tile k are at most 5 k t; each
    tile writes its whole 6 t staging capacity at the cursor, whose bytes
    past the tile's total the next tile overwrites."""
    return 5 * -(-n // t) * t + 6 * t


def _fill_tile(host: np.ndarray, flat: np.ndarray, k: int, t: int) -> None:
    """Tile k of the (n, 3|4) pixels into the (t, 4) uint8 buffer `host`:
    alpha 255 for 3 channels (qoi.h:411-413), zeros past the image."""
    piece = flat[k * t:(k + 1) * t]
    c = piece.shape[0]
    host[:c, :piece.shape[1]] = piece
    if piece.shape[1] == 3:
        host[:c, 3] = 255
    host[c:] = 0


class _TileUploader:
    """Pixel tiles onto the device, `depth` tiles ahead of the compute.

    On a card each tile is filled into a pinned host buffer and copied on
    a side stream into a device slot; events order the copy after the
    compute that last read the slot, and the compute after the copy.
    The host fill runs in the caller's thread, while the card works on
    the tile before: a failure raises in the caller, and nothing waits on
    a producer that died. On the CPU a tile is the filled buffer itself."""

    def __init__(self, flat: np.ndarray, t: int, dev: torch.device,
                 depth: int):
        self.flat, self.t, self.depth = flat, t, depth
        self.cuda = dev.type == "cuda"
        self.host = [torch.empty((t, 4), dtype=torch.uint8,
                                 pin_memory=self.cuda) for _ in range(depth)]
        if self.cuda:
            self.compute = torch.cuda.current_stream(dev)
            self.side = torch.cuda.Stream(dev)
            self.slots = [torch.empty((t, 4), dtype=torch.uint8, device=dev)
                          for _ in range(depth)]
            self.uploaded = [torch.cuda.Event() for _ in range(depth)]
            self.released = [torch.cuda.Event() for _ in range(depth)]

    def put(self, k: int) -> None:
        j = k % self.depth
        if self.cuda:
            self.uploaded[j].synchronize()  # host[j]'s last copy is done
        _fill_tile(self.host[j].numpy(), self.flat, k, self.t)
        if self.cuda:
            self.side.wait_event(self.released[j])
            with torch.cuda.stream(self.side):
                self.slots[j].copy_(self.host[j], non_blocking=True)
            self.uploaded[j].record(self.side)

    def get(self, k: int) -> torch.Tensor:
        j = k % self.depth
        if not self.cuda:
            return self.host[j]
        self.compute.wait_event(self.uploaded[j])
        return self.slots[j]

    def release(self, k: int) -> None:
        """The compute queued so far is the last to read tile k's slot."""
        if self.cuda:
            self.released[k % self.depth].record(self.compute)


def encode(pixels: np.ndarray, desc: fmt.StreamDesc, device,
           tile_px: int = 0, config=None) -> bytes:
    """Encode one image of any size the format allows on `device`;
    byte-identical to the reference encoder (qoi.h:356). Tiles of
    `tile_px` pixels (default `config.stream_tile_px`, else 2^22); each
    tile's bytes land at the byte cursor of one device buffer."""
    if not tile_px:
        tile_px = config.stream_tile_px if config else 1 << 22
    desc.validate()
    flat = np.asarray(pixels, dtype=np.uint8).reshape(-1, desc.channels)
    if flat.shape[0] != desc.num_pixels:
        raise ValueError(f"pixel count {flat.shape[0]} != {desc.num_pixels} "
                         "from descriptor")
    dev = torch.device(device)
    n = flat.shape[0]
    t = min(tile_px, bucket_size(n))
    n_tiles = -(-n // t)
    out = torch.empty(_encode_capacity(n, t), dtype=torch.uint8, device=dev)
    depth = min(_DEPTH, n_tiles)
    up = _TileUploader(flat, t, dev, depth)
    for k in range(depth):
        up.put(k)
    carry = {}
    cursor = 0
    for k in range(n_tiles):
        ch = pipeline.encode_stage_chunks(
            up.get(k), min(n - k * t, t), contains_last=n <= (k + 1) * t,
            form="words", **carry)
        words, total = compact.compact_words6_wordsum(
            ch.lo, ch.hi, ch.lens, t * 6, seg=min(t, 20480))
        up.release(k)
        if k + depth < n_tiles:
            up.put(k + depth)   # while the card encodes tile k
        total = int(total)      # the one host read a tile
        out[cursor:cursor + 6 * t] = words.view(torch.uint8)
        cursor += total
        c = ch.carry
        carry = dict(prev_in=c.prev_px, run_in=c.run,
                     table_in=(c.table, c.written))
    return (fmt.pack_header(desc) + out[:cursor].cpu().numpy().tobytes()
            + fmt.TRAILER)


# ---------------------------------------------------------------------------
# Decode. Tiles end exactly at chunk boundaries: the FSM state at position
# t - 8 says how far the chunk straddling it extends (ops/fsm.py).
# ---------------------------------------------------------------------------

_LOOKBEHIND = 8     # byte window of a tile: t - 8; a chunk is <= 5 bytes
_PX_BUDGET_MIN = 64  # progress guarantee: one chunk yields <= 62 px


def _unpack65(entry65: torch.Tensor):
    """(65,) int64 u32 state -> ((4,) uint8 px, (64, 4) uint8 table)."""
    return scan_codec._unpack65(to_i32(entry65))


def _pack65(px: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """(4,) uint8 px and (64, 4) uint8 table -> (65,) int64 u32 state."""
    return u32(scan_codec._pack65(px, table))


def _seed65(dev: torch.device) -> torch.Tensor:
    """The decoder's start state: the seed px and an empty table."""
    seed = torch.zeros(65, dtype=torch.int64, device=dev)
    seed[0] = _SEED32
    return seed


def _tile_end(data_t: torch.Tensor, lim: int, p_budget: int) -> int:
    """The last chunk boundary of the tile within BOTH the byte window
    (t - 8) and the pixel budget. The stream end (lim) is a boundary too,
    taken only when its pixel total also fits."""
    t = data_t.shape[0]
    starts, state_before = fsm.chunk_starts_and_state(data_t, lim)
    b0 = data_t.to(torch.int64)
    is_run = ((b0 & fmt.MASK_2) == fmt.OP_RUN) & (b0 < fmt.OP_RGB)
    npix_b = torch.where(starts, torch.where(is_run, (b0 & 63) + 1, 1), 0)
    pixexc = exclusive_cumsum(npix_b)
    cons_b = torch.clamp(state_before[t - _LOOKBEHIND].to(torch.int64)
                         + (t - _LOOKBEHIND), max=lim)
    io = torch.arange(t, device=data_t.device)
    ok = ((state_before == 0) & (io <= cons_b) & (pixexc <= p_budget)
          & (io <= lim))
    last_ok, cons_b, tot_pix = torch.stack([
        torch.where(ok, io, 0).max(), cons_b,
        pixexc[-1] + npix_b[-1]]).tolist()
    return lim if lim <= cons_b and tot_pix <= p_budget else last_ok


def _dec_tile_at(data_all: torch.Tensor, cursor: int, chunks_len: int,
                 entry65, t: int, p_budget: int, max_rounds: int,
                 n_want: int):
    """One decode tile at the byte cursor: t bytes, ended at the last
    chunk boundary within the byte window and the pixel budget, decoded
    from entry65 by the fixpoint and expanded with entry65's px as the
    seed or, when the fixpoint does not converge (a non-canonical
    stream), by the sequential scan from the same entry state. Returns
    (its first min(pixels, n_want) pixels (n,) int32, consumed bytes,
    exit65)."""
    data_t = data_all[cursor:cursor + t]
    consumed = _tile_end(data_t, min(chunks_len - cursor, t), p_budget)
    px, _, npix, pix_off, conv, _, exit65 = decode_v3._decode_core(
        data_t, consumed, max_rounds, entry65)
    n_out = min(int(pix_off[-1] + npix[-1]), n_want)
    if conv:
        return (expand_px(pix_off.to(torch.int32), to_i32(px), n_out,
                          seed32=entry65[0]), consumed, exit65)
    out4, (f_px, f_table) = scan_codec._decode_scan(
        data_t, n_out, consumed, *_unpack65(entry65))
    return (out4.reshape(-1).view(torch.int32), consumed,
            _pack65(f_px, f_table))


def decode(data: bytes, channels: int, device, tile_bytes: int = 0,
           max_rounds: int = 0, config=None
           ) -> Tuple[np.ndarray, fmt.StreamDesc]:
    """Decode a stream of any size the format allows on `device`;
    pixel-identical to the reference decoder (qoi.h:488), including
    truncation tolerance and channel forcing. Tiles of `tile_bytes` bytes
    (default `config.stream_tile_px`, else 2^22) and up to `max_rounds`
    fixpoint rounds (default `config.decode_max_iters`, else 12).

    The stream uploads once; each tile's pixels land at the pixel cursor
    of one device plane, and the tile's exit state is the next one's
    entry. A tile ends at a chunk boundary, so every tile makes progress;
    the loop ends at the stream's end or at the header's pixel count,
    whichever comes first, and a short stream repeats its last pixel."""
    if not tile_bytes:
        tile_bytes = config.stream_tile_px if config else 1 << 22
    if not max_rounds:
        max_rounds = config.decode_max_iters if config else 12
    if channels not in (0, 3, 4):
        raise ValueError(f"channels must be 0, 3 or 4, got {channels}")
    desc = fmt.unpack_header(data)
    out_ch = channels if channels else desc.channels
    n_px = desc.num_pixels
    dev = torch.device(device)

    chunks = np.frombuffer(data, dtype=np.uint8)[fmt.HEADER_SIZE:]
    chunks_len = len(data) - fmt.HEADER_SIZE - fmt.TRAILER_SIZE
    t = max(1024, tile_bytes)
    p_budget = max(t, _PX_BUDGET_MIN)
    data_np = np.zeros((chunks_len + t,), np.uint8)
    m = min(len(chunks), data_np.shape[0])
    data_np[:m] = chunks[:m]
    data_all = torch.from_numpy(data_np).to(dev)
    plane = torch.empty(n_px, dtype=torch.int32, device=dev)

    entry = _seed65(dev)
    cursor = px_cursor = 0
    while cursor < chunks_len and px_cursor < n_px:
        part, consumed, entry = _dec_tile_at(
            data_all, cursor, chunks_len, entry, t, p_budget, max_rounds,
            n_px - px_cursor)
        plane[px_cursor:px_cursor + part.shape[0]] = part
        cursor += consumed
        px_cursor += part.shape[0]
    plane[px_cursor:] = to_i32(entry[:1])  # truncated: repeat the last px
    px4 = plane.cpu().numpy().view(np.uint8).reshape(-1, 4)
    img = px4[:, :out_ch].reshape(desc.height, desc.width, out_ch)
    return img, desc
