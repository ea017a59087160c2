"""Gather-free parallel QOI decoder v2 (port of qoi_tpu/models/decode_v2.py),
a cross-check engine beside the v1 and v3 decoders.

It works on per-BYTE arrays (non-start bytes are identities), so it needs
no record compaction:

  fields       per-byte shifted arrays: flags, literal, deltas, pixel counts
  hash chain   hashes of the current px estimate
  INDEX values `ops/table.table_select_local/carry`: the table value each
               INDEX reads, under last-writer-wins
  pixel values per-channel reset-or-add scans (DIFF/LUMA add mod 256,
               RGB/RGBA/INDEX reset, RUN identity): the one-pass kernel
               `kernels/blocked_scan.resolve_scan` on the card

INDEX indirection (a chunk copying a value that came through INDEX itself)
is the one recurrence left: it resolves by a host-level fixpoint of rounds,
each a table query and a scan; round k is exact for every chunk whose
INDEX nesting is < k. A round that changes no px certifies the decode; a
stream that does not converge in `_MAX_ROUNDS` goes to the v1 decoder
(which falls back to the sequential one). Plain PyTorch on the given
device around that scan, one host read a round.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .. import format as fmt
from ..kernels import blocked_scan as kbs
from ..ops import fsm, table
from ..ops.scans import exclusive_cumsum, last_mark
from . import decode_pipeline as v1

_MAX_ROUNDS = 12


def _shift_up(x: torch.Tensor, k: int) -> torch.Tensor:
    """x[i] <- x[i + k]; the tail filled with zeros."""
    return torch.cat([x[k:], x.new_zeros(k)])


def _seed(dev) -> torch.Tensor:
    return torch.tensor(fmt.SEED_PIXEL, dtype=torch.uint8, device=dev)


def _fields(data: torch.Tensor, chunks_len):
    """Per-byte chunk fields. data: (M,) uint8. Returns (flags, lit,
    deltas, npix, pix_off), (M,) int64 each: flags packs starts | rgb << 1
    | rgba << 2 | index << 3 | diff << 4 | luma << 5 | run << 6, lit the
    bytes b2..b5 as u32, deltas the mod-256 (dr, dg, db) bytes."""
    starts = fsm.chunk_starts(data, chunks_len)
    d1 = data.to(torch.int64)
    d2, d3, d4, d5 = (_shift_up(d1, k) for k in (1, 2, 3, 4))

    is_rgb = (d1 == fmt.OP_RGB) & starts
    is_rgba = (d1 == fmt.OP_RGBA) & starts
    two = d1 & fmt.MASK_2
    other = ~is_rgb & ~is_rgba & starts
    is_index = other & (two == fmt.OP_INDEX)
    is_diff = other & (two == fmt.OP_DIFF)
    is_luma = other & (two == fmt.OP_LUMA)
    is_run = other & (two == fmt.OP_RUN)

    npix = torch.where(is_run, (d1 & 0x3F) + 1, 1) * starts.to(torch.int64)

    dr = torch.where(is_diff, ((d1 >> 4) & 3) - 2, 0)
    dg2 = torch.where(is_diff, ((d1 >> 2) & 3) - 2, 0)
    db = torch.where(is_diff, (d1 & 3) - 2, 0)
    vg = (d1 & 0x3F) - 32
    lr = vg - 8 + ((d2 >> 4) & 0x0F)
    lb = vg - 8 + (d2 & 0x0F)
    dr = torch.where(is_luma, lr, dr) & 0xFF
    dg = torch.where(is_luma, vg, dg2) & 0xFF
    db = torch.where(is_luma, lb, db) & 0xFF

    flags = torch.zeros_like(d1)
    for bit, flag in enumerate((starts, is_rgb, is_rgba, is_index, is_diff,
                                is_luma, is_run)):
        flags |= flag.to(torch.int64) << bit
    lit = d2 | d3 << 8 | d4 << 16 | d5 << 24
    deltas = dr | dg << 8 | db << 16
    return flags, lit, deltas, npix, exclusive_cumsum(npix)


def _unpack_flags(flags: torch.Tensor):
    return {name: (flags >> bit) & 1 != 0 for bit, name in enumerate(
        ("starts", "is_rgb", "is_rgba", "is_index", "is_diff", "is_luma",
         "is_run"))}


def _bytes4(x: torch.Tensor) -> torch.Tensor:
    """(M,) u32 -> (4, M) uint8, the low byte first."""
    return torch.stack([((x >> s) & 0xFF).to(torch.uint8)
                        for s in (0, 8, 16, 24)])


def _resolve_scan(f, lit, deltas, idx_val, idx_found):
    """Per-channel reset-or-add scans -> the px after every byte, (4, M)
    uint8, channel-major: one `resolve_scan` (the kernel on a CUDA
    tensor) of `_resolve_leaves`."""
    return kbs.resolve_scan(*_resolve_leaves(f, lit, deltas, idx_val,
                                             idx_found))


def _resolve_leaves(f, lit, deltas, idx_val, idx_found):
    """The scan's leaves: (rflag, val), (4, M) uint8 each, channel-major:
    RGB/RGBA/INDEX reset to their value, DIFF/LUMA add their deltas.
    idx_val / idx_found: the values the INDEX chunks read this round (an
    unfound slot reads the zero entry)."""
    lit_b = _bytes4(lit)
    d_b = _bytes4(deltas)      # byte 3 is 0: no alpha delta
    iv = _bytes4(torch.where(idx_found, idx_val, 0))

    lit_rgb = f["is_rgb"] | f["is_rgba"]
    reset_rgb = lit_rgb | f["is_index"]
    reset_a = f["is_rgba"] | f["is_index"]
    rflag = torch.stack([reset_rgb, reset_rgb, reset_rgb, reset_a])
    rval = torch.where(torch.stack([lit_rgb, lit_rgb, lit_rgb, f["is_rgba"]]),
                       lit_b, iv)
    return rflag.to(torch.uint8), torch.where(rflag, rval, d_b)


def _round_a(data, flags, pxa):
    """Fixpoint round, phase A: hashes of the current px estimate, then
    the table query's phase A. Returns (local, qk)."""
    f = _unpack_flags(flags)
    hm = fmt.HASH_MULTIPLIERS
    px = pxa.to(torch.int64)
    hashes = torch.where(f["starts"], (px[0] * hm[0] + px[1] * hm[1]
                                       + px[2] * hm[2] + px[3] * hm[3]) & 63,
                         0)
    qk = torch.where(f["is_index"], data.to(torch.int64) & 63, hashes)
    packed = px[0] | px[1] << 8 | px[2] << 16 | px[3] << 24
    return table.table_select_local(hashes, packed, f["starts"], qk), qk


def _round_b(flags, lit, deltas, qk, local, pxa_prev):
    """Phase B: the INDEX values, the scans, and the count of bytes whose
    px changed. Returns (pxa, changed (0-d int64))."""
    f = _unpack_flags(flags)
    idx_val, idx_found, _ = table.table_select_carry(local, qk)
    pxa = _resolve_scan(f, lit, deltas, idx_val, idx_found)
    return pxa, (pxa != pxa_prev).any(dim=0).sum()


def _expand(flags, pxa, npix, pix_off, n_px_cap: int) -> torch.Tensor:
    """Run expansion: the chunk start byte of every pixel (`last_mark`
    over the starts' offsets, the JAX cummax) and one gather a channel.
    Returns (4, n_px_cap) uint8."""
    starts = _unpack_flags(flags)["starts"]
    dev = flags.device
    io = torch.arange(flags.shape[0], device=dev)
    keep = starts & (pix_off < n_px_cap)
    marks = torch.full((n_px_cap,), -1, dtype=torch.int64, device=dev)
    marks[pix_off[keep]] = io[keep]
    pixel_byte = last_mark(marks)
    ok = pixel_byte >= 0
    return torch.where(ok[None], pxa[:, pixel_byte.clamp(min=0)],
                       _seed(dev)[:, None])


def _decode_v2_device(data: torch.Tensor, chunks_len, n_px_cap: int):
    """Host-orchestrated decode of one padded stream body. Returns
    (pixels (4, n_px_cap) uint8, converged (bool), rounds (int))."""
    flags, lit, deltas, npix, pix_off = _fields(data, chunks_len)
    f = _unpack_flags(flags)
    # round 0: INDEX chunks read the zero entry
    pxa = _resolve_scan(f, lit, deltas, torch.zeros_like(lit),
                        torch.zeros_like(f["starts"]))
    converged, rounds = False, 0
    while rounds < _MAX_ROUNDS:
        local, qk = _round_a(data, flags, pxa)
        pxa, changed = _round_b(flags, lit, deltas, qk, local, pxa)
        rounds += 1
        if int(changed) == 0:  # the host read
            converged = True
            break
    return _expand(flags, pxa, npix, pix_off, n_px_cap), converged, rounds


def decode_group(data: torch.Tensor, chunks_len, n_px_cap: int):
    """Decode same-bucket streams one after another. data: (B, M) uint8;
    chunks_len: B ints. Returns (pixels (B, 4, n_px_cap) uint8, converged
    (bool): every stream converged). A stream's rounds stop at its own
    fixpoint; the JAX group runs its streams' rounds together until all
    converge, and a converged stream's further rounds change nothing, so
    the pixels are the same."""
    outs, conv = [], True
    for i in range(data.shape[0]):
        out, c, _ = _decode_v2_device(data[i], int(chunks_len[i]), n_px_cap)
        outs.append(out)
        conv = conv and c
    return torch.stack(outs), conv


def stream_body(data: bytes, dev):
    """A stream's body (its bytes after the header) zero-padded to its
    bucket, on dev, and its chunks_len: what `decode` gives
    `_decode_v2_device`."""
    chunks = np.frombuffer(data, dtype=np.uint8)[fmt.HEADER_SIZE:]
    padded = np.zeros((v1.bucket_size(len(chunks)),), np.uint8)
    padded[: len(chunks)] = chunks
    return (torch.from_numpy(padded).to(dev),
            len(data) - fmt.HEADER_SIZE - fmt.TRAILER_SIZE)


def round0_leaves(body: torch.Tensor, chunks_len):
    """The leaves (rflag, val) of round 0's resolve scan of a padded body,
    INDEX chunks reading the zero entry, as `_decode_v2_device` builds
    them."""
    flags, lit, deltas, _, _ = _fields(body, chunks_len)
    f = _unpack_flags(flags)
    return _resolve_leaves(f, lit, deltas, torch.zeros_like(lit),
                           torch.zeros_like(f["starts"]))


def decode(data: bytes, channels: int = 0, device="cuda"
           ) -> Tuple[np.ndarray, fmt.StreamDesc]:
    """Decode a QOI stream on `device` through the gather-free pipeline;
    pixel-identical to the reference decoder (qoi.h:488). A stream that
    does not converge goes to the v1 decoder (which falls back to the
    sequential one)."""
    from .. import _device

    dev = _device(device)
    if channels not in (0, 3, 4):
        raise ValueError(f"channels must be 0, 3 or 4, got {channels}")
    desc = fmt.unpack_header(data)
    out_ch = channels if channels else desc.channels

    body, chunks_len = stream_body(data, dev)
    px4, converged, _ = _decode_v2_device(body, chunks_len,
                                          v1.bucket_size(desc.num_pixels))
    if not converged:
        return v1.decode(data, channels, dev)
    img = px4.T[: desc.num_pixels, :out_ch].cpu().numpy()
    return img.reshape(desc.height, desc.width, out_ch), desc
