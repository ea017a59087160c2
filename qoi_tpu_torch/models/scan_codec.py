"""Sequential codec: the reference recurrence walked one pixel at a time
(port of qoi_tpu/models/scan_codec.py).

The bit-exactness anchor: a literal transcription of the per-pixel state
machines (encoder: qoi.h:406-478; decoder: qoi.h:540-587). Each of the two
walks is one CUDA kernel on the card (kernels/scan_codec.py over
csrc/scan_codec.cu) and a plain twin on the CPU. The decoder is the
decode ladder's floor (the v1 decoder's fallback, models/decode_pipeline.py)
and, with an entry state, the streamed decoder's repair of tiles whose
fixpoint does not converge.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .. import format as fmt
from ..kernels import scan_codec as kscan
from ..kernels.scan_codec import classify_literal  # noqa: F401
from ..ops.table import hash64 as _hash64  # noqa: F401

_SEED = torch.tensor(fmt.SEED_PIXEL, dtype=torch.uint8)


def _encode_scan(pixels4: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Walk the pixels; per pixel up to 6 bytes (run flush + chunk).
    pixels4: (N, 4) uint8, alpha pre-forced to 255 for 3-channel input
    (qoi.h:411-413). Returns (staging (N, 6) uint8, lens (N,) int32)."""
    return kscan.encode_scan(
        pixels4.contiguous().view(torch.int32).reshape(-1))


def encode(pixels: np.ndarray, desc: fmt.StreamDesc, device) -> bytes:
    """Encode on `device` through the sequential walk; byte-identical to
    the reference encoder."""
    desc.validate()
    flat = np.asarray(pixels, dtype=np.uint8).reshape(-1, desc.channels)
    if flat.shape[0] != desc.num_pixels:
        raise ValueError("pixel count mismatch")
    if desc.channels == 3:
        flat = np.concatenate(
            [flat, np.full((flat.shape[0], 1), 255, np.uint8)], axis=1)
    staging, lens = _encode_scan(torch.from_numpy(flat).to(device))
    # compaction on the host, as the JAX anchor does
    staging, lens = staging.cpu().numpy(), lens.cpu().numpy()
    body = staging[np.arange(6)[None, :] < lens[:, None]]
    return fmt.pack_header(desc) + body.tobytes() + fmt.TRAILER


def _pack65(px: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """(4,) uint8 px and (64, 4) uint8 table -> (65,) int32 packed state."""
    return torch.cat([px.reshape(1, 4), table]).to(
        torch.uint8).contiguous().view(torch.int32).reshape(65)


def _unpack65(state: torch.Tensor):
    """(65,) int32 packed state -> ((4,) uint8 px, (64, 4) uint8 table)."""
    u8 = state.to(torch.int32).contiguous().view(torch.uint8).reshape(65, 4)
    return u8[0], u8[1:]


def _decode_scan(data: torch.Tensor, n_px: int, chunks_len: int,
                 entry_px=None, entry_table=None):
    """Walk n_px output pixels (qoi.h:540-587). data: (T,) uint8 stream
    starting at the first chunk byte; chunks_len: the bytes before the
    trailer. `entry_px` (4,) uint8 / `entry_table` (64, 4) uint8 chain a
    tile's state for the streamed decoder (default the seed px and an
    empty table). Returns (pixels (n_px, 4) uint8, (exit_px, exit_table))."""
    dev = data.device
    px = _SEED.to(dev) if entry_px is None else entry_px
    table = (torch.zeros((64, 4), dtype=torch.uint8, device=dev)
             if entry_table is None else entry_table)
    out, exit65 = kscan.decode_scan(data.contiguous(), n_px, int(chunks_len),
                                    _pack65(px.to(dev), table.to(dev)))
    return out.view(torch.uint8).reshape(n_px, 4), _unpack65(exit65)


def decode(data: bytes, channels: int, device
           ) -> Tuple[np.ndarray, fmt.StreamDesc]:
    """Decode on `device` through the sequential walk; pixel-identical to
    the reference decoder, including truncation tolerance and channel
    forcing."""
    if channels not in (0, 3, 4):
        raise ValueError(f"channels must be 0, 3 or 4, got {channels}")
    desc = fmt.unpack_header(data)
    out_ch = channels if channels else desc.channels
    chunks = np.frombuffer(data, dtype=np.uint8)[fmt.HEADER_SIZE:].copy()
    chunks_len = len(data) - fmt.HEADER_SIZE - fmt.TRAILER_SIZE
    px4, _ = _decode_scan(torch.from_numpy(chunks).to(device),
                          desc.num_pixels, chunks_len)
    img = px4.cpu().numpy()[:, :out_ch]
    return img.reshape(desc.height, desc.width, out_ch), desc
