"""Data-parallel QOI decoder v1, the pointer-doubling pipeline (port of
qoi_tpu/models/decode_pipeline.py), and the shape buckets of the decode
buffers.

The reference decoder is a sequential chunk-at-a-time state machine with
four loop carries (px, run, index[64], read cursor; qoi.h:540-587). Every
carry becomes a data-parallel or log-depth stage:

  1. tokenize     5-state FSM composition -> chunk starts   (ops/fsm.py)
  2. fields       per-chunk type, deltas, pixel counts
  3. hash chain   "reset-or-add" affine scan mod 64
  4. table replay last earlier writer of each INDEX slot    (ops/table.py)
  5. resolve      pointer doubling over additive chains     (ops/link.py)
  6. expand       run expansion from the chunks' pixel offsets

Stages 3-5 iterate to a fixpoint: the replay is exact iff the hashes it
wrote with equal the hashes of the resolved pixels. Canonical streams
converge in one iteration, alpha-varying or non-canonical ones (an INDEX
read of a never-written slot decodes the zero entry, `zero_hit`) in a few
more. The loop runs in Python, with one host read of the certificate an
iteration; a stream that does not converge in `_MAX_FIXPOINT_ITERS` goes
to the sequential decoder (models/scan_codec.py), so the output always
matches the reference decoder. Plain PyTorch on the given device: no
kernel of its own (the sequential fallback is the decode_scan kernel on
the card). It is the decode ladder's rung between the native decoder and
the scan (decode_v3._decode_ladder).
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .. import format as fmt
from ..ops import fsm, link, table
from ..ops.scans import (assoc_scan, exclusive_cumsum, last_mark,
                         last_true_index)
from . import scan_codec

_SEED_HASH = fmt.hash_rgba(*fmt.SEED_PIXEL)
_MAX_FIXPOINT_ITERS = 12


def bucket_size(n: int, floor: int = 256) -> int:
    """Next power of two >= n (and >= floor)."""
    b = floor
    while b < n:
        b <<= 1
    return b


def bucket_size_fine(n: int, floor: int = 256) -> int:
    """Quarter-power-of-two bucket (2^k * {1, 1.25, 1.5, 1.75}) for sizes
    >= 2^20, at most ~14.3% padding; smaller sizes keep pow2 buckets.
    Every candidate divides the decoder's scan blocks."""
    if n < (1 << 20):
        return bucket_size(n, floor)
    b = 1 << 20
    while b < n:
        b <<= 1
    for frac in (4, 5, 6, 7):
        cand = (b >> 3) * frac
        if cand >= n:
            return cand
    return b


def _u8(x: torch.Tensor) -> torch.Tensor:
    """Integers -> uint8 mod 256."""
    return (x & 0xFF).to(torch.uint8)


def _chunk_fields(data: torch.Tensor, start_pos: torch.Tensor,
                  valid: torch.Tensor):
    """Gather each chunk's bytes and classify it. data: (M,) uint8;
    start_pos: (M,) chunk start positions (slots past the last chunk hold
    M - 1); valid: (M,) bool. Returns a dict as the JAX function's: b1
    int64, b2..b5 uint8, the op flags bool, npix int64 and the mod-256
    deltas dr, dg, db uint8."""
    m = data.shape[0]
    start_pos = start_pos.to(torch.int64)

    def g(off):
        return data[(start_pos + off).clamp(max=m - 1)]

    b1 = g(0).to(torch.int64)
    b2, b3, b4, b5 = g(1), g(2), g(3), g(4)

    is_rgb = (b1 == fmt.OP_RGB) & valid
    is_rgba = (b1 == fmt.OP_RGBA) & valid
    two = b1 & fmt.MASK_2
    other = ~is_rgb & ~is_rgba & valid
    is_index = other & (two == fmt.OP_INDEX)
    is_diff = other & (two == fmt.OP_DIFF)
    is_luma = other & (two == fmt.OP_LUMA)
    is_run = other & (two == fmt.OP_RUN)

    npix = torch.where(is_run, (b1 & 0x3F) + 1, 1) * valid.to(torch.int64)

    # mod-256 deltas as the decoder applies them (reference qoi.h:562-572)
    dr = torch.where(is_diff, ((b1 >> 4) & 3) - 2, 0)
    dg2 = torch.where(is_diff, ((b1 >> 2) & 3) - 2, 0)
    db = torch.where(is_diff, (b1 & 3) - 2, 0)
    vg = (b1 & 0x3F) - 32
    lr = vg - 8 + ((b2.to(torch.int64) >> 4) & 0x0F)
    lb = vg - 8 + (b2.to(torch.int64) & 0x0F)
    return dict(
        b1=b1, b2=b2, b3=b3, b4=b4, b5=b5,
        is_rgb=is_rgb, is_rgba=is_rgba, is_index=is_index,
        is_diff=is_diff, is_luma=is_luma, is_run=is_run, npix=npix,
        dr=_u8(torch.where(is_luma, lr, dr)),
        dg=_u8(torch.where(is_luma, vg, dg2)),
        db=_u8(torch.where(is_luma, lb, db)),
    )


def _initial_hashes(f, valid: torch.Tensor) -> torch.Tensor:
    """Optimistic hash after each chunk by a reset-or-add affine scan mod
    64: exact for canonical 3-channel streams, iterated otherwise. An RGB
    literal's reset takes the alpha of the last RGBA literal before it
    (`last_true_index`, the count-and-scatter form of the JAX cummax),
    else 255. Returns (M,) int64."""
    last_rgba = last_true_index(f["is_rgba"])
    prev_rgba = torch.cat([last_rgba.new_full((1,), -1), last_rgba[:-1]])
    alpha_opt = torch.where(prev_rgba >= 0,
                            f["b5"][prev_rgba.clamp(min=0)].to(torch.int64),
                            255)

    m3, m5, m7, m11 = fmt.HASH_MULTIPLIERS
    b2, b3, b4, b5 = (f[k].to(torch.int64) for k in ("b2", "b3", "b4", "b5"))
    rgb = m3 * b2 + m5 * b3 + m7 * b4
    reset_val = torch.where(
        f["is_rgba"], (rgb + m11 * b5) & 63,
        torch.where(f["is_rgb"], (rgb + m11 * alpha_opt) & 63,
                    f["b1"] & 63))   # INDEX: table invariant => hash == slot
    is_reset = f["is_rgba"] | f["is_rgb"] | f["is_index"]
    add_val = (m3 * f["dr"].to(torch.int64) + m5 * f["dg"].to(torch.int64)
               + m7 * f["db"].to(torch.int64)) & 63

    def combine(a, b):  # a earlier, b later
        (ra, va), (rb, vb) = a, b
        return rb | ra, torch.where(rb != 0, vb, (va + vb) & 63)

    rs, vs = assoc_scan(combine, (is_reset.to(torch.int64),
                                  torch.where(is_reset, reset_val, add_val)))
    return torch.where(rs == 1, vs, (vs + _SEED_HASH) & 63)


def _resolve_values(f, hashes: torch.Tensor, valid: torch.Tensor,
                    start_pos: torch.Tensor) -> torch.Tensor:
    """One replay and pointer-doubling pass given the assumed hash after
    each chunk. Returns (M, 4) uint8 px after each chunk."""
    n = valid.shape[0]
    dev = valid.device
    io = torch.arange(n, device=dev)

    qkeys = torch.where(f["is_index"], f["b1"] & 63, hashes)
    target1, _ = table.table_replay(hashes, io + 1, write=valid,
                                    query_keys=qkeys)
    target = target1 - 1  # -1: the zero table entry

    parent1 = torch.where(f["is_index"], target, io - 1)  # -1: the seed
    # an INDEX into a never-written slot decodes the zero entry (0,0,0,0)
    zero_hit = f["is_index"] & (target < 0)

    anchored_rgb = f["is_rgb"] | f["is_rgba"] | zero_hit | ~valid
    anchored_a = f["is_rgba"] | zero_hit | ~valid
    anchored = torch.stack([anchored_rgb, anchored_rgb, anchored_rgb,
                            anchored_a], dim=1)
    lit = f["is_rgb"] | f["is_rgba"]
    anchor = torch.stack([
        torch.where(lit, f["b2"], 0), torch.where(lit, f["b3"], 0),
        torch.where(lit, f["b4"], 0), torch.where(f["is_rgba"], f["b5"], 0),
    ], dim=1)
    delta = torch.stack([f["dr"], f["dg"], f["db"],
                         torch.zeros_like(f["dr"])], dim=1)
    parent = parent1.to(torch.int32)[:, None].expand(n, 4)
    seed = torch.tensor(fmt.SEED_PIXEL, dtype=torch.uint8, device=dev)
    return link.resolve(parent, delta, anchored, anchor, seed)


def _decode_chunks(data: torch.Tensor, chunks_len: int, n_px: int):
    """Chunk-level decode. data: (M,) uint8 with the trailer and padding;
    n_px: the output capacity (callers bucket it; pixels past the true
    count are cut on the host). Returns ((n_px, 4) uint8, converged
    (bool), iterations (int)). The fixpoint runs at most
    `_MAX_FIXPOINT_ITERS` iterations; an unconverged one ends with a
    resolve from its last hashes, as the JAX function's final resolve
    (which, converged, gives the px it already has)."""
    m = data.shape[0]
    dev = data.device
    starts = fsm.chunk_starts(data, chunks_len)
    io = torch.arange(m, device=dev)

    # compact the chunk starts' positions into record slots (capacity M)
    cid = exclusive_cumsum(starts)
    start_pos = torch.full((m + 1,), m - 1, dtype=torch.int64, device=dev)
    start_pos[torch.where(starts, cid, m)] = io
    start_pos = start_pos[:m]
    valid = io < cid[-1] + starts[-1]

    f = _chunk_fields(data, start_pos, valid)

    # fixpoint: hashes -> replay -> values -> hashes
    hashes = torch.where(valid, _initial_hashes(f, valid), 0)
    converged, iters = False, 0
    while not converged and iters < _MAX_FIXPOINT_ITERS:
        px = _resolve_values(f, hashes, valid, start_pos)
        true_h = torch.where(valid, table.hash64(px), 0)
        converged = bool((true_h == hashes).all())  # the host read
        hashes = true_h
        iters += 1
    if not converged:
        px = _resolve_values(f, hashes, valid, start_pos)

    # run expansion: the chunk of every pixel from the chunks' offsets
    pix_off = exclusive_cumsum(f["npix"])
    keep = valid & (pix_off < n_px)
    marks = torch.full((n_px,), -1, dtype=torch.int64, device=dev)
    marks[pix_off[keep]] = io[keep]
    pixel_chunk = last_mark(marks)
    # truncation tolerance (reference qoi.h:544): pixels before any chunk
    # keep the seed, pixels after the last chunk keep the last px
    seed = torch.tensor(fmt.SEED_PIXEL, dtype=torch.uint8, device=dev)
    out = torch.where(pixel_chunk[:, None] >= 0,
                      px[pixel_chunk.clamp(min=0)], seed[None])
    return out, converged, iters


def decode(data: bytes, channels: int = 0, device="cuda"
           ) -> Tuple[np.ndarray, fmt.StreamDesc]:
    """Decode a QOI stream on `device` through the pointer-doubling
    pipeline; pixel-identical to the reference decoder (qoi.h:488),
    truncation and channel forcing included. A stream whose fixpoint does
    not converge goes to the sequential decoder, `scan_codec.decode`."""
    from .. import _device

    dev = _device(device)
    if channels not in (0, 3, 4):
        raise ValueError(f"channels must be 0, 3 or 4, got {channels}")
    desc = fmt.unpack_header(data)
    out_ch = channels if channels else desc.channels

    chunks = np.frombuffer(data, dtype=np.uint8)[fmt.HEADER_SIZE:]
    chunks_len = len(data) - fmt.HEADER_SIZE - fmt.TRAILER_SIZE
    padded = np.zeros((bucket_size(len(chunks)),), np.uint8)
    padded[: len(chunks)] = chunks

    px4, converged, _ = _decode_chunks(torch.from_numpy(padded).to(dev),
                                       chunks_len,
                                       bucket_size(desc.num_pixels))
    if not converged:
        return scan_codec.decode(data, channels, dev)
    img = px4[: desc.num_pixels, :out_ch].cpu().numpy()
    return img.reshape(desc.height, desc.width, out_ch), desc
