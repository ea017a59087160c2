"""Color-index-table replay (port of qoi_tpu/ops/table.py).

After any non-run pixel p the reference table holds index[hash(p)] == p
(store-on-miss, qoi.h:436), so the table value a position reads is the
value of the most recent preceding writer of its slot, or the incoming
table entry. The JAX package answers that with gather-free blocked brute
force, a TPU answer. Here one stable sort by slot groups each slot's
positions in order, and the last-true-index of the sorted write mask finds
every position's last earlier writer; hits and the final table follow
with two gathers. The encoder's `table_hit` queries the slot it writes;
the decoder's `table_replay` and `table_select_local/carry` (the v1 and v2
decoders) query another slot (an INDEX reads b1 & 63 and writes
hash(px)), so their sort holds a query event and a write event per
position. Their `block` argument is the JAX package's brute-force width
and has no effect here.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from .. import format as fmt
from .scans import exclusive_cumsum, last_true_index

_SLOTS = 64
_BLOCK = 64


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


def table_select_local(keys: torch.Tensor, vals: torch.Tensor,
                       write: torch.Tensor, query_keys: torch.Tensor,
                       block: int = _BLOCK):
    """Phase A of the table query: each position's last earlier writer of
    the slot it queries, and each slot's last writer.

    keys: (N,) slot each position writes (where `write`); query_keys: (N,)
    slot each position reads; vals: (N,) u32 value each position writes.
    One sort orders the N query and N write events by (slot, position,
    query before write), so a query does not see its own position's
    write; `last_true_index` of the sorted write mask then finds, for
    every event, the last write at or before it, which counts when it
    lies in the same slot's group. Returns (writer (N,) int64, the
    position of the last earlier writer or -1; final (64,) int64, each
    slot's last writer or -1; vals) -- the port's own phase-A tuple."""
    n = keys.shape[0]
    dev = keys.device
    io = torch.arange(n, device=dev)
    slot = torch.cat([query_keys.to(torch.int64), keys.to(torch.int64)])
    order = torch.sort(torch.cat([slot[:n] * (2 * n) + 2 * io,
                                  slot[n:] * (2 * n) + 2 * io + 1])).indices
    is_w = torch.cat([torch.zeros_like(write), write])[order]
    counts = torch.bincount(slot, minlength=_SLOTS)
    gstart = exclusive_cumsum(counts)
    last_w = last_true_index(is_w)
    own = last_w >= gstart[slot[order]]
    src = torch.where(own, order[last_w.clamp(min=0)] - n, -1)
    writer = torch.empty(n, dtype=torch.int64, device=dev)
    is_q = order < n
    writer[order[is_q]] = src[is_q]
    end = last_w[(gstart + counts - 1).clamp(min=0)]
    final = torch.where((counts > 0) & (end >= gstart),
                        order[end.clamp(min=0)] - n, -1)
    return writer, final, vals


def table_select_carry(local, query_keys: torch.Tensor,
                       block: int = _BLOCK,
                       incoming: Optional[Tuple[torch.Tensor,
                                                torch.Tensor]] = None):
    """Phase B: the table VALUE at query_keys[i] just before position i,
    with the incoming state (table (64,) u32, written (64,) bool) under
    the positions' own writes; an unwritten slot reads 0.

    Returns (before (N,) int64 u32, found (N,) bool, (final_table (64,)
    int64 u32, final_written (64,) bool)), the JAX phase B's outputs."""
    writer, final, vals = local
    dev = writer.device
    vals = vals.to(torch.int64)
    if incoming is None:
        inc_t = torch.zeros(_SLOTS, dtype=torch.int64, device=dev)
        inc_w = torch.zeros(_SLOTS, dtype=torch.bool, device=dev)
    else:
        inc_t, inc_w = incoming[0].to(torch.int64), incoming[1]
    inc_v = torch.where(inc_w, inc_t, 0)
    qk = query_keys.to(torch.int64)
    has = writer >= 0
    before = torch.where(has, vals[writer.clamp(min=0)], inc_v[qk])
    wrote = final >= 0
    final_table = torch.where(wrote, vals[final.clamp(min=0)], inc_v)
    return before, has | inc_w[qk], (final_table, wrote | inc_w)


def table_replay(keys: torch.Tensor, vals: torch.Tensor,
                 write: torch.Tensor, block: int = _BLOCK,
                 incoming: Optional[Tuple[torch.Tensor,
                                          torch.Tensor]] = None,
                 query_keys: Optional[torch.Tensor] = None):
    """Per-position table lookups under last-writer-wins replay: both
    phases at once. query_keys defaults to keys. Returns (before (N,)
    int64 u32, (final_table (64,) int64 u32, final_written (64,) bool)),
    as the JAX `table_replay`."""
    if query_keys is None:
        query_keys = keys
    before, _, final = table_select_carry(
        table_select_local(keys, vals, write, query_keys), query_keys,
        incoming=incoming)
    return before, final
