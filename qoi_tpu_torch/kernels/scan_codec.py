"""The sequential QOI codec: CUDA kernels `csrc/scan_codec.cu` and their
plain twins.

Counterparts of the two `lax.scan`s of qoi_tpu/models/scan_codec.py: the
reference encoder and decoder (qoi.h:406-478, qoi.h:540-587). Each kernel
computes what its scan computes, not its one-pixel step. The decoder is
one block of three warps: a producer stages the bytes into shared memory,
a front warp finds the chunk starts of each 32-byte window by pointer
jumping and each chunk's map, and a walker warp composes the maps by a
warp scan and resolves the INDEX chunks by warp fixpoint rounds, the
table in registers. The encoder is one block taking 1024 pixels at once
(run counters and table hits from ballots and per-slot last writers,
carried between groups). The header of csrc/scan_codec.cu gives the
design. The twins walk the same recurrence in Python integers over the
tensors' values: the plain statement of the reference, and slow (a few
microseconds a pixel), which the tests' sizes allow.

Pixels travel packed, one u32 per pixel (r in the low byte), as int32 bit
patterns; a decoder state is the packed (65,) px + 64 slots.

CPU tensors take the twins; CUDA tensors launch the kernels (or raise).
"""
from __future__ import annotations

import torch

from .. import format as fmt
from .._bits import M32, to_i32
from ..ops.table import hash64
from . import _build
from .expand import _SEED32


def classify_literal(px: torch.Tensor, px_prev: torch.Tensor):
    """Op selection for a non-run, table-miss pixel (reference
    qoi.h:438-474), elementwise over (..., 4) uint8 pixels. Returns
    (bytes5 (..., 5) uint8, the chunk padded to 5 bytes; length (...,)
    int32)."""
    d = (px[..., :3].to(torch.int64) - px_prev[..., :3].to(torch.int64))
    d = ((d + 128) & 0xFF) - 128                 # as signed char
    vr, vg, vb = d[..., 0], d[..., 1], d[..., 2]
    vg_r = ((vr - vg + 128) & 0xFF) - 128
    vg_b = ((vb - vg + 128) & 0xFF) - 128
    alpha_same = px[..., 3] == px_prev[..., 3]

    def small(v):
        return (v >= -2) & (v <= 1)

    is_diff = alpha_same & small(vr) & small(vg) & small(vb)
    is_luma = (alpha_same & ~is_diff & (vg >= -32) & (vg <= 31)
               & (vg_r >= -8) & (vg_r <= 7) & (vg_b >= -8) & (vg_b <= 7))
    is_rgb = alpha_same & ~is_diff & ~is_luma
    diff_b0 = fmt.OP_DIFF | (vr + 2) << 4 | (vg + 2) << 2 | (vb + 2)
    luma_b0 = fmt.OP_LUMA | (vg + 32)
    luma_b1 = (vg_r + 8) << 4 | (vg_b + 8)
    r, g, b, a = (px[..., k].to(torch.int64) for k in range(4))
    short = is_diff | is_luma
    b0 = torch.where(is_diff, diff_b0, torch.where(
        is_luma, luma_b0, torch.where(is_rgb, fmt.OP_RGB, fmt.OP_RGBA)))
    b1 = torch.where(is_diff, 0, torch.where(is_luma, luma_b1, r))
    b2 = torch.where(short, 0, g)
    b3 = torch.where(short, 0, b)
    b4 = torch.where(short | is_rgb, 0, a)
    length = torch.where(is_diff, 1, torch.where(
        is_luma, 2, torch.where(is_rgb, 4, 5))).to(torch.int32)
    return torch.stack([b0, b1, b2, b3, b4], dim=-1).to(torch.uint8), length


def _hash32(p: int) -> int:
    return (3 * (p & 0xFF) + 5 * ((p >> 8) & 0xFF) + 7 * ((p >> 16) & 0xFF)
            + 11 * (p >> 24)) & 63


def encode_scan_plain(px32: torch.Tensor):
    """Plain twin of the encode kernel: the reference encoder (qoi.h:
    406-478) one pixel at a time. px32: (N,) int32 packed pixels, alpha
    255 for 3-channel sources. Returns (staging (N, 6) uint8: per pixel a
    pending run's flush byte, if any, then its chunk, zero padded -- a
    run member keeps its run byte in byte 0 with length 0; lens (N,)
    int32). The literal chunks depend only on each pixel and the one
    before it, so `classify_literal` gives them all at once."""
    px4 = px32.contiguous().view(torch.uint8).reshape(-1, 4)
    prev4 = torch.cat([torch.tensor([fmt.SEED_PIXEL], dtype=torch.uint8,
                                    device=px4.device), px4[:-1]])
    lit, lit_len = (x.tolist() for x in classify_literal(px4, prev4))
    ps = [x & M32 for x in px32.tolist()]
    n = len(ps)
    table = [0] * 64
    prev, run = _SEED32, 0
    staging, lens = [], []
    for i, p in enumerate(ps):
        if p == prev:
            run += 1
            emit = run == fmt.RUN_CAP or i == n - 1
            staging.append([fmt.OP_RUN | (run - 1), 0, 0, 0, 0, 0])
            lens.append(int(emit))
            if emit:
                run = 0
            continue
        slot = _hash32(p)
        if table[slot] == p:
            own, own_len = [fmt.OP_INDEX | slot, 0, 0, 0, 0], 1
        else:
            own, own_len = lit[i], lit_len[i]
            table[slot] = p
        if run:
            staging.append([fmt.OP_RUN | (run - 1)] + own)
            lens.append(own_len + 1)
        else:
            staging.append(own + [0])
            lens.append(own_len)
        prev, run = p, 0
    return (torch.tensor(staging, dtype=torch.uint8,
                         device=px32.device).reshape(n, 6),
            torch.tensor(lens, dtype=torch.int32, device=px32.device))


def encode_scan(px32: torch.Tensor):
    """The reference encoder walked in order (see encode_scan_plain).
    CPU tensors take the plain twin; CUDA tensors launch the kernel (or
    raise)."""
    if px32.dim() != 1:
        raise ValueError(f"encode_scan: px32 {tuple(px32.shape)}, want (N,)")
    if px32.device.type == "cpu":
        return encode_scan_plain(px32)
    _build.check_cuda("encode_scan", px32)
    n = px32.numel()
    dev = px32.device
    staging = torch.empty((n, 6), dtype=torch.uint8, device=dev)
    lens = torch.empty(n, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        rc = _build.lib().qoi_encode_scan(
            px32.data_ptr(), n, staging.data_ptr(), lens.data_ptr(),
            _build.stream_ptr(dev))
    _build.launched("encode_scan", rc)
    return staging, lens


def decode_scan_plain(data: torch.Tensor, n_px: int, chunks_len: int,
                      state65: torch.Tensor):
    """Plain twin of the decode kernel: the reference decoder (qoi.h:
    540-587) one output pixel at a time, from the entry state state65
    ((65,) int32: packed px + 64 slots). data: (T,) uint8, read from
    byte 0; a chunk starts only below chunks_len, and its later bytes
    are read clamped to T - 1. Returns (pixels (n_px,) int32 packed,
    exit state (65,) int32)."""
    d = data.tolist()
    last = len(d) - 1
    st = [x & M32 for x in state65.tolist()]
    px, table = st[0], st[1:]
    out = [0] * n_px
    run = p = 0
    for i in range(n_px):
        if run == 0 and p < chunks_len:
            b1, b2, b3, b4, b5 = (d[min(p + k, last)] for k in range(5))
            tag = b1 & fmt.MASK_2
            if b1 == fmt.OP_RGB:
                px = b2 | b3 << 8 | b4 << 16 | (px & 0xFF000000)
                p += 4
            elif b1 == fmt.OP_RGBA:
                px = b2 | b3 << 8 | b4 << 16 | b5 << 24
                p += 5
            elif tag == fmt.OP_INDEX:
                px = table[b1 & 63]
                p += 1
            elif tag == fmt.OP_DIFF:
                px = _byte_add(px, ((b1 >> 4) & 3) - 2, ((b1 >> 2) & 3) - 2,
                               (b1 & 3) - 2)
                p += 1
            elif tag == fmt.OP_LUMA:
                vg = (b1 & 0x3F) - 32
                px = _byte_add(px, vg - 8 + (b2 >> 4), vg, vg - 8 + (b2 & 15))
                p += 2
            else:                                   # RUN
                run = b1 & 0x3F
                p += 1
            table[_hash32(px)] = px
        elif run > 0:
            run -= 1
        out[i] = px
    dev = data.device
    return (to_i32(torch.tensor(out, dtype=torch.int64, device=dev)),
            to_i32(torch.tensor([px] + table, dtype=torch.int64, device=dev)))


def exit_state_of(px32: torch.Tensor, entry65: torch.Tensor) -> torch.Tensor:
    """The exit state that a decode from entry65 leaves after writing the
    pixels px32 ((n,) int32, n >= 1), when it read at least one chunk: the
    last px, and per slot the last pixel that hashes to it, else the entry
    slot. The decoder writes the table after every chunk, and run pixels
    and pixels past chunks_len repeat a px it has already written, so the
    pixels alone fix the state. (65,) int32."""
    slot = hash64(px32.contiguous().view(torch.uint8).reshape(-1, 4))
    last = torch.full((64,), -1, dtype=torch.int64, device=px32.device)
    last.scatter_reduce_(0, slot, torch.arange(px32.numel(),
                                               device=px32.device), "amax")
    table = torch.where(last >= 0, px32[last.clamp(min=0)], entry65[1:])
    return torch.cat([px32[-1:], table])


def _byte_add(px: int, dr: int, dg: int, db: int) -> int:
    """px + (dr, dg, db, 0) per channel, mod 256."""
    return (((px & 0xFF) + dr) & 0xFF | (((px >> 8) + dg) & 0xFF) << 8
            | (((px >> 16) + db) & 0xFF) << 16 | px & 0xFF000000)


def decode_scan(data: torch.Tensor, n_px: int, chunks_len: int,
                state65: torch.Tensor):
    """The reference decoder walked in order (see decode_scan_plain). CPU
    tensors take the plain twin; CUDA tensors launch the kernel (or
    raise)."""
    if data.dim() != 1 or state65.shape != (65,):
        raise ValueError(f"decode_scan: data {tuple(data.shape)} and state "
                         f"{tuple(state65.shape)}, want (T,) and (65,)")
    if data.device.type == "cpu" and state65.device.type == "cpu":
        return decode_scan_plain(data, n_px, chunks_len, state65)
    _build.check_cuda("decode_scan", data, dtype=torch.uint8)
    _build.check_cuda("decode_scan", state65)
    dev = data.device
    out = torch.empty(n_px, dtype=torch.int32, device=dev)
    exit65 = torch.empty(65, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        rc = _build.lib().qoi_decode_scan(
            data.data_ptr(), data.numel(),
            chunks_len if data.numel() else 0, n_px, state65.data_ptr(),
            out.data_ptr(), exit65.data_ptr(), _build.stream_ptr(dev))
    _build.launched("decode_scan", rc)
    return out, exit65
