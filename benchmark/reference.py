"""Plain reference QOI encoder in torch, vectorised, on any device.

It follows the reference `qoi.h` (phoboslab/qoi, `qoi_encode`) op for op
and imports nothing of the program. The sequential carries of qoi.h's
loop become whole-array steps:

- run: pixel i equal to pixel i-1 (the seed (0,0,0,255) before pixel 0)
  extends the run; a RUN op is emitted at every 62nd pixel of a run, at
  the image's last pixel, and before the next differing pixel's op;
- index: a differing pixel hits the index when the last earlier
  differing pixel with the same hash slot has its value (the table is
  zero at the start, so a (0,0,0,0) pixel hits slot 0 until that slot is
  written); every differing pixel leaves its value in its slot;
- otherwise DIFF, LUMA, RGB or RGBA from the wrapped channel deltas.

Each pixel stages at most six bytes (a pending RUN, then its own op) and
one cumulative sum places them.

The control of the benchmark is this encoder, and the frame itself as
the decode's answer, at 7 bits a channel (`seven_bit`): the step below
the 8-bit exactness that the configurations state.
"""
from __future__ import annotations

import torch

SEED = (0, 0, 0, 255)
TRAILER = bytes(7) + b"\x01"
OP_INDEX, OP_DIFF, OP_LUMA, OP_RUN, OP_RGB, OP_RGBA = (
    0x00, 0x40, 0x80, 0xC0, 0xFE, 0xFF)


def header(width: int, height: int, channels: int = 4,
           colorspace: int = 0) -> bytes:
    return (b"qoif" + width.to_bytes(4, "big") + height.to_bytes(4, "big")
            + bytes((channels, colorspace)))


def _wrap(d: torch.Tensor) -> torch.Tensor:
    """int64 difference -> signed 8-bit value, as qoi.h's `signed char`."""
    return (d + 128) % 256 - 128


def encode_body(px: torch.Tensor) -> torch.Tensor:
    """The chunk bytes (no header, no trailer) of the QOI stream of px, an
    (N, 4) uint8 RGBA tensor; returns a (total,) uint8 tensor on px's
    device."""
    if px.dim() != 2 or px.shape[1] != 4 or px.dtype != torch.uint8:
        raise ValueError("px must be an (N, 4) uint8 tensor")
    dev = px.device
    n = px.shape[0]
    p = px.to(torch.int64)
    prev = torch.cat([torch.tensor([SEED], device=dev), p[:-1]])
    eq = (p == prev).all(dim=1)
    pos = torch.arange(n, device=dev)

    # run length so far at each position (1.. within a run)
    last_ne = torch.cummax(torch.where(eq, -1, pos), dim=0).values
    run = pos - last_ne
    run_mod = run % 62
    emit_run = eq & ((run_mod == 0) | (pos == n - 1))
    run_byte_at = OP_RUN | torch.where(run_mod == 0, 61, run_mod - 1)
    # a differing pixel first flushes the run that ends before it
    prev_run_mod = torch.cat([torch.zeros(1, dtype=torch.int64, device=dev),
                              run_mod[:-1]])
    prev_eq = torch.cat([torch.zeros(1, dtype=torch.bool, device=dev),
                         eq[:-1]])
    flush = ~eq & prev_eq & (prev_run_mod != 0)

    # index hits: the previous differing pixel in the same slot
    h = (p[:, 0] * 3 + p[:, 1] * 5 + p[:, 2] * 7 + p[:, 3] * 11) % 64
    ne = torch.nonzero(~eq).squeeze(1)
    key = h[ne]
    order = torch.sort(key, stable=True).indices
    sk = key[order]
    sp = ne[order]
    same = torch.zeros_like(sk, dtype=torch.bool)
    same[1:] = sk[1:] == sk[:-1]
    earlier = torch.full_like(sp, -1)
    earlier[1:] = torch.where(same[1:], sp[:-1], -1)
    e_px = p[earlier.clamp(min=0)]
    hit_sorted = torch.where(same, (e_px == p[sp]).all(dim=1),
                             (p[sp] == 0).all(dim=1))
    hit = torch.zeros(n, dtype=torch.bool, device=dev)
    hit[sp] = hit_sorted

    d = _wrap(p - prev)
    dr, dg, db = d[:, 0], d[:, 1], d[:, 2]
    same_a = p[:, 3] == prev[:, 3]
    dr_dg = _wrap(dr - dg)
    db_dg = _wrap(db - dg)
    is_diff = (same_a & (dr >= -2) & (dr <= 1) & (dg >= -2) & (dg <= 1)
               & (db >= -2) & (db <= 1))
    is_luma = (same_a & ~is_diff & (dg >= -32) & (dg <= 31)
               & (dr_dg >= -8) & (dr_dg <= 7) & (db_dg >= -8) & (db_dg <= 7))
    is_rgb = same_a & ~is_diff & ~is_luma

    # the pixel's own op: (length, six bytes)
    zero = torch.zeros_like(h)
    op = torch.stack([zero] * 5, dim=1)
    op_len = torch.full_like(h, 5)
    op[:, 0] = OP_RGBA
    op[:, 1:5] = p
    rgb = torch.stack([torch.full_like(h, OP_RGB), p[:, 0], p[:, 1],
                       p[:, 2], zero], dim=1)
    op = torch.where(is_rgb[:, None], rgb, op)
    op_len = torch.where(is_rgb, 4, op_len)
    luma = torch.stack([OP_LUMA | (dg + 32), (dr_dg + 8) << 4 | (db_dg + 8),
                        zero, zero, zero], dim=1)
    op = torch.where(is_luma[:, None], luma, op)
    op_len = torch.where(is_luma, 2, op_len)
    diff = torch.stack([OP_DIFF | (dr + 2) << 4 | (dg + 2) << 2 | (db + 2),
                        zero, zero, zero, zero], dim=1)
    op = torch.where(is_diff[:, None], diff, op)
    op_len = torch.where(is_diff, 1, op_len)
    index = torch.stack([OP_INDEX | h, zero, zero, zero, zero], dim=1)
    op = torch.where(hit[:, None], index, op)
    op_len = torch.where(hit, 1, op_len)
    op_len = torch.where(eq, 0, op_len)

    lead = torch.where(flush, OP_RUN | (prev_run_mod - 1),
                       run_byte_at)
    has_lead = flush | emit_run
    stage = torch.cat([lead[:, None], op], dim=1)
    # a pixel without a lead byte starts at its op's first byte
    stage = torch.where(has_lead[:, None], stage,
                        torch.cat([op, zero[:, None]], dim=1))
    lens = has_lead.to(torch.int64) + op_len
    ends = torch.cumsum(lens, dim=0)
    total = int(ends[-1]) if n else 0
    starts = ends - lens
    out = torch.zeros(total, dtype=torch.uint8, device=dev)
    for j in range(6):
        m = lens > j
        out[starts[m] + j] = stage[m, j].to(torch.uint8)
    return out


def encode(px: torch.Tensor, width: int, height: int,
           channels: int = 4) -> bytes:
    """The whole stream (header, chunks, trailer) as bytes."""
    body = encode_body(px).cpu().numpy().tobytes()
    return header(width, height, channels) + body + TRAILER


def seven_bit(px: torch.Tensor) -> torch.Tensor:
    """The control's precision: every channel's lowest bit dropped."""
    return px & 0xFE
