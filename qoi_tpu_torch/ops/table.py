"""Color-index-table replay (port of qoi_tpu/ops/table.py).

After any non-run pixel p the reference table holds index[hash(p)] == p
(store-on-miss, qoi.h:436), so the table value a position reads is the
value of the most recent preceding writer of its slot, or the incoming
table entry. The JAX package answers that with gather-free blocked brute
force, a TPU answer. Here one stable sort by slot groups each slot's
positions in order, and the last-true-index of the sorted write mask finds
every position's last earlier writer; hits and the final table follow
with two gathers.

The encoder's `table_hit` queries the slot it writes. Its two phases,
`table_hit_local` and `table_hit_carry`, sort by (block, slot) for a
caller that runs them apart; their intermediates are per-block facts,
so their `block` takes effect, and `table_hit` is the two at one block
spanning the buffer. The decoder's `table_replay` and
`table_select_local/carry` (the v1 and v2 decoders) query another slot
(an INDEX reads b1 & 63 and writes hash(px)), so their sort holds a
query event and a write event per position; their `block` argument is
the JAX package's brute-force width and has no effect here.
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


def table_hit_local(keys: torch.Tensor, vals: torch.Tensor,
                    write: torch.Tensor, block: int = _BLOCK):
    """Phase A of `table_hit`: the facts local to each `block`-position
    block. keys: (N,) slot per position; vals: (N,) int64 u32 packed
    pixel; write: (N,) bool.

    Returns (hit_in (N,) bool: a same-slot writer precedes i in its block
    and the last one wrote vals[i]; has_local (N,) bool: such a writer
    exists; s_written (nb, 64) bool: the block writes the slot; s_val
    (nb, 64) int64 u32: the value of the block's last writer of the slot,
    0 where none) -- the JAX outputs, s_val as u32 values where JAX has
    their int32 bit patterns. One stable sort by (block, slot) answers
    what the JAX function answers with (nb, b, b) brute-force masks."""
    n = keys.shape[0]
    nb = -(-n // block)
    io = torch.arange(n, device=keys.device)
    groups = (io // block) * _SLOTS + keys.to(torch.int64)
    # one stable sort by group; every position's last earlier writer in
    # its group (sorted index, else -1), and every group's last writer
    order = torch.sort(groups, stable=True).indices
    counts = torch.bincount(groups, minlength=nb * _SLOTS)
    gstart = exclusive_cumsum(counts)
    last_w = last_true_index(write[order])
    prev = torch.cat([last_w.new_full((1,), -1), last_w[:-1]])
    prev = torch.where(prev >= gstart[groups[order]], prev, -1)
    end = last_w[(gstart + counts - 1).clamp(min=0)]
    end = torch.where((counts > 0) & (end >= gstart), end, -1)
    sv = vals.to(torch.int64)[order]
    has = prev >= 0
    hit = has & (sv[prev.clamp(min=0)] == sv)
    hit_in = torch.empty_like(hit)
    hit_in[order] = hit
    has_local = torch.empty_like(has)
    has_local[order] = has
    s_written = (end >= 0).reshape(nb, _SLOTS)
    s_val = torch.where(end >= 0, sv[end.clamp(min=0)], 0).reshape(nb, _SLOTS)
    return hit_in, has_local, s_written, s_val


def table_hit_carry(
    local,
    keys: torch.Tensor,
    vals: torch.Tensor,
    block: int = _BLOCK,
    incoming: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Phase B of `table_hit`: the table entering each block (the last
    earlier block that wrote each slot, else the incoming entry), a hit
    test against it for the positions with no writer earlier in their
    block, and the final table. `local` is `table_hit_local`'s output at
    the same `block`; incoming: optional (table (64,) u32, written (64,)
    bool), unwritten entries reading 0.

    Returns (hit (N,) bool, (final_table (64,) int64 u32, final_written
    (64,) bool)). A never-written slot reads 0 == pack_rgba(0, 0, 0, 0),
    the zero table entry, so `entry == vals` is the hit test either way."""
    hit_in, has_local, s_written, s_val = local
    dev = keys.device
    nb = s_written.shape[0]
    if incoming is None:
        inc_t = torch.zeros(_SLOTS, dtype=torch.int64, device=dev)
        inc_w = torch.zeros(_SLOTS, dtype=torch.bool, device=dev)
    else:
        inc_t, inc_w = incoming[0].to(torch.int64), incoming[1]
    inc_v = torch.where(inc_w, inc_t, 0)
    blk = torch.arange(nb, device=dev)[:, None]
    last_blk = torch.cummax(torch.where(s_written, blk, -1), dim=0).values
    before = torch.cat([last_blk.new_full((1, _SLOTS), -1), last_blk[:-1]])
    entry = torch.where(before >= 0, s_val.gather(0, before.clamp(min=0)),
                        inc_v[None, :])                       # (nb, 64)
    io = torch.arange(keys.shape[0], device=dev)
    carry_val = entry[io // block, keys.to(torch.int64)]
    hit = torch.where(has_local, hit_in, carry_val == vals.to(torch.int64))
    fin = last_blk[-1]
    final_table = torch.where(
        fin >= 0, s_val.gather(0, fin.clamp(min=0)[None, :])[0], inc_v)
    return hit, (final_table, (fin >= 0) | inc_w)


def table_hit(
    keys: torch.Tensor,
    vals: torch.Tensor,
    write: torch.Tensor,
    incoming: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """INDEX-hit detection under last-writer-wins replay: both phases
    with one block spanning the buffer, so one sort by slot does the
    work and the carry only reads the incoming table.

    keys: (N,) slot per position; vals: (N,) int64 u32 packed pixel;
    write: (N,) bool; incoming: optional (table (64,) int64 u32, written
    (64,) bool) state entering the buffer (unwritten entries read 0).

    Returns (hit (N,) bool, (final_table (64,) int64 u32, final_written
    (64,) bool)), with hit[i] == (table value at keys[i] just before i ==
    vals[i]) -- the outputs of the JAX `table_hit`, which do not depend
    on its block width."""
    block = max(keys.shape[0], 1)
    return table_hit_carry(table_hit_local(keys, vals, write, block),
                           keys, vals, block, incoming)


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
