"""Color-index-table replay for the encoder (port of qoi_tpu/ops/table.py).

After any non-run pixel p the reference table holds index[hash(p)] == p
(store-on-miss, qoi.h:436), so the table value a position reads is the
value of the most recent preceding writer of its slot, or the incoming
table entry. The JAX package answers that with gather-free blocked brute
force, a TPU answer. Here one stable sort by slot groups each slot's
positions in order, and the last-true-index of the sorted write mask finds
every position's last earlier writer; hits and the final table follow
with two gathers.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from .. import format as fmt
from .scans import exclusive_cumsum, last_true_index

_SLOTS = 64


def pack_rgba(px4: torch.Tensor) -> torch.Tensor:
    """Pack (..., 4) uint8 into (...,) int64 u32: r | g<<8 | b<<16 | a<<24.
    packed(0,0,0,0) == 0 == the zero table entry."""
    x = px4.to(torch.int64)
    return x[..., 0] | x[..., 1] << 8 | x[..., 2] << 16 | x[..., 3] << 24


def hash64(px4: torch.Tensor) -> torch.Tensor:
    """Table slot (reference qoi.h:92-94). px4: (..., 4) uint8 -> int64."""
    x = px4.to(torch.int64)
    m = fmt.HASH_MULTIPLIERS
    return (x[..., 0] * m[0] + x[..., 1] * m[1] + x[..., 2] * m[2]
            + x[..., 3] * m[3]) & (_SLOTS - 1)


def table_hit(
    keys: torch.Tensor,
    vals: torch.Tensor,
    write: torch.Tensor,
    incoming: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """INDEX-hit detection under last-writer-wins replay.

    keys: (N,) slot per position; vals: (N,) int64 u32 packed pixel;
    write: (N,) bool; incoming: optional (table (64,) int64 u32, written
    (64,) bool) state entering the buffer (unwritten entries read 0).

    Returns (hit (N,) bool, (final_table (64,) int64 u32, final_written
    (64,) bool)), with hit[i] == (table value at keys[i] just before i ==
    vals[i]) -- the same outputs as the JAX `table_hit`."""
    dev = keys.device
    if incoming is None:
        inc_t = torch.zeros(_SLOTS, dtype=torch.int64, device=dev)
        inc_w = torch.zeros(_SLOTS, dtype=torch.bool, device=dev)
    else:
        inc_t, inc_w = incoming
        inc_t = inc_t.to(torch.int64)
    inc_v = torch.where(inc_w, inc_t, 0)

    order = torch.sort(keys, stable=True).indices
    sk, sv, sw = keys[order], vals[order], write[order]
    counts = torch.bincount(keys, minlength=_SLOTS)
    gstart = exclusive_cumsum(counts)                  # (64,) group starts
    # last writer at or before each sorted index (-1: none so far)
    last_w = last_true_index(sw)
    prev = torch.cat([last_w.new_full((1,), -1), last_w[:-1]])
    has = prev >= gstart[sk]                           # writer in own slot
    before = torch.where(has, sv[prev.clamp(min=0)], inc_v[sk])
    hit = torch.empty_like(write)
    hit[order] = before == sv

    end_w = last_w[(gstart + counts - 1).clamp(min=0)]
    wrote = (counts > 0) & (end_w >= gstart)
    final_table = torch.where(wrote, sv[end_w.clamp(min=0)], inc_v)
    return hit, (final_table, wrote | inc_w)
