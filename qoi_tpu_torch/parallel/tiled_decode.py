"""Sequence-parallel decode: ONE stream, its bytes split over the "seq"
axis of a mesh (port of qoi_tpu/parallel/tiled_decode.py, on
torch.distributed).

Every rank owns a contiguous byte range of one stream, and the decoder's
four carries cross the range boundaries as small summaries:

  cursor    -- FSM transition maps (ops/fsm), composed over the ranks, so
               each rank's entry state marks its chunk starts without
               scanning its neighbours' bytes
  hash      -- per-rank (reset?, add) affine maps mod 64, composed the
               same way (with the last RGBA literal's alpha for the
               optimistic guess)
  index[64] -- last-writer summaries over GLOBAL chunk ids
  px        -- each local chunk resolves by pointer doubling (ops/link) to
               a local anchor or to one of 65 symbols (the incoming pixel,
               the incoming table slots 0..63); the ranks' symbolic
               summaries compose in S host steps, and one local
               substitution finishes

under a global hash fixpoint, as the v1 decoder's
(models/decode_pipeline): converged means the replay used the true
hashes, so the output equals the reference decoder's. The run expansion
is sharded too (`_expand_tiled`): per-chunk mod-256 deltas scattered into
the global pixel plane, a reduce-scatter onto each rank's pixel range,
and a sharded prefix sum.

Collectives, as in the JAX package: the tokenize maps with the 4-byte
halo (one all_gather); the chunk, pixel and alpha scalars (one); the hash
maps (one); a round of the fixpoint one table gather, one (65, 8)
summary gather and one all_reduce of the certificate; the expansion one
boundary gather, one reduce-scatter and one totals gather. The replicated
composes of S rows run on the host. A stream whose fixpoint does not
converge in 12 rounds is decoded by v1 (`decode_pipeline.decode`) on every
rank, as the JAX package falls back to its v1 decoder.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from .. import format as fmt
from .._bits import to_i32
from ..models import decode_pipeline as dp
from ..ops import fsm, link, table
from ..ops.scans import assoc_scan, exclusive_cumsum, last_true_index
from . import sharding

_NSYM = 65   # symbol 0: the incoming px; symbols 1..64: incoming slot s-1
_MAX_ITERS = 12


class ShardOut(NamedTuple):
    """One rank's chunk-level decode (the JAX tile step's five outputs,
    and the fixpoint's rounds)."""

    px: torch.Tensor       # (Mb, 4) uint8 px after each local chunk
    npix: torch.Tensor     # (Mb,) int64 pixels of each local chunk
    pix_off: torch.Tensor  # (Mb,) int64 global pixel offset of each chunk
    nloc: int              # local chunk count
    conv: bool             # the global fixpoint converged
    rounds: int


def _shard_fields(data: torch.Tensor, chunks_len: int, ax):
    """Stages 1 and 2: the chunk starts of this byte range from its entry
    state, the chunk records (a 4-byte halo from the next rank covers a
    chunk that crosses the boundary), and the pixel and chunk offsets."""
    mb = data.shape[0]
    dev = data.device
    io = torch.arange(mb, device=dev)
    trans = fsm._pack_map(fsm.chunk_byte_len(data) - 1)
    incl = assoc_scan(fsm._compose_maps, trans)
    d = data[:4].to(torch.int64)
    halo_w = d[0] | d[1] << 8 | d[2] << 16 | d[3] << 24
    st1 = ax.all_gather(torch.stack([incl[-1], halo_w])).cpu()   # (S, 2)
    m = fsm._pack_map(torch.tensor(0))
    for x in st1[:ax.index, 0]:
        m = fsm._compose_maps(m, x)
    entry = int(m) & 7                          # digit of state 0
    state_after = (incl >> (3 * entry)) & 7
    state_before = torch.cat([state_after.new_full((1,), entry),
                              state_after[:-1]])
    starts = (state_before == 0) & (ax.index * mb + io < chunks_len)

    halo_in = 0 if ax.index == ax.size - 1 else int(st1[ax.index + 1, 1])
    halo = torch.tensor([(halo_in >> (8 * k)) & 0xFF for k in range(4)],
                        dtype=torch.uint8, device=dev)
    cid = exclusive_cumsum(starts)
    start_pos = torch.full((mb + 1,), mb - 1, dtype=torch.int64, device=dev)
    start_pos[torch.where(starts, cid, mb)] = io   # slot mb: dropped
    start_pos = start_pos[:mb]
    nloc = cid[-1] + starts[-1]
    valid = io < nloc
    f = dp._chunk_fields(torch.cat([data, halo]), start_pos, valid)

    last_rgba = last_true_index(f["is_rgba"])
    last = last_rgba[-1]
    alpha_fin = torch.where(
        last >= 0, f["b5"][last.clamp(min=0)].to(torch.int64), -1)
    st2 = ax.all_gather(torch.stack([nloc, f["npix"].sum(), alpha_fin]))
    nlocs, npix_sums, alpha_fins = st2.cpu().T.tolist()
    gid_base = sum(nlocs[:ax.index])
    pix_off = sum(npix_sums[:ax.index]) + exclusive_cumsum(f["npix"])
    alpha_entry = 255
    for a in alpha_fins[:ax.index]:
        alpha_entry = a if a >= 0 else alpha_entry
    prev_rgba = torch.cat([last_rgba.new_full((1,), -1), last_rgba[:-1]])
    alpha_opt = torch.where(prev_rgba >= 0,
                            f["b5"][prev_rgba.clamp(min=0)].to(torch.int64),
                            alpha_entry)
    return f, valid, int(nloc), gid_base, pix_off, alpha_opt


def _initial_hashes(f, valid, alpha_opt, ax) -> torch.Tensor:
    """Stage 3: the optimistic hash after each local chunk, by the local
    reset-or-add scan and the composed entry hash."""
    m3, m5, m7, m11 = fmt.HASH_MULTIPLIERS
    b2, b3, b4, b5 = (f[k].to(torch.int64) for k in ("b2", "b3", "b4", "b5"))
    rgb = m3 * b2 + m5 * b3 + m7 * b4
    reset_val = torch.where(
        f["is_rgba"], (rgb + m11 * b5) & 63,
        torch.where(f["is_rgb"], (rgb + m11 * alpha_opt) & 63,
                    f["b1"] & 63))
    is_reset = (f["is_rgba"] | f["is_rgb"] | f["is_index"]) & valid
    add_val = torch.where(
        valid, (m3 * f["dr"].to(torch.int64) + m5 * f["dg"].to(torch.int64)
                + m7 * f["db"].to(torch.int64)) & 63, 0)

    def combine(a, b):  # a earlier, b later
        (ra, va), (rb, vb) = a, b
        return rb | ra, torch.where(rb != 0, vb, (va + vb) & 63)

    hr, hv = assoc_scan(combine, (is_reset.to(torch.int64),
                                  torch.where(is_reset, reset_val, add_val)))
    shard_hs = ax.all_gather(torch.stack([hr[-1], hv[-1]])).cpu().tolist()
    h_entry = dp._SEED_HASH
    for r, v in shard_hs[:ax.index]:
        h_entry = v if r == 1 else (h_entry + v) & 63
    return torch.where(valid, torch.where(hr == 1, hv, (h_entry + hv) & 63),
                       0)


def _resolve(f, valid, hashes, gid_base: int, nloc: int, ax) -> torch.Tensor:
    """Stages 4-6 given the hash after each chunk: the replay over global
    writer ids with the composed incoming table, the symbolic pointer
    doubling, the composed symbol values and the substitution. Returns
    (Mb, 4) uint8 px after each local chunk."""
    mb = valid.shape[0]
    dev = valid.device
    io = torch.arange(mb, device=dev)
    qk = torch.where(f["is_index"], f["b1"] & 63, hashes)
    gids1 = gid_base + io + 1
    _, (loc_tbl, loc_wr) = table.table_replay(hashes, gids1, write=valid)
    tw = ax.all_gather(torch.stack([loc_tbl, loc_wr.to(torch.int64)]))
    inc_t = torch.zeros(64, dtype=torch.int64, device=dev)
    inc_w = torch.zeros(64, dtype=torch.bool, device=dev)
    for t, w in tw[:ax.index].to(dev):
        inc_t = torch.where(w != 0, t, inc_t)
        inc_w = inc_w | (w != 0)
    target1, _ = table.table_replay(hashes, gids1, write=valid,
                                    incoming=(inc_t, inc_w), query_keys=qk)
    target = target1 - 1                 # global chunk id, -1: zero entry

    # parent per chunk: an INDEX its target (a local node, or the symbol
    # of the incoming slot it reads), else the previous chunk (node mb:
    # the incoming px symbol)
    tgt_local = target - gid_base
    parent1 = torch.where(
        f["is_index"],
        torch.where(target < 0, 0,
                    torch.where(tgt_local >= 0, tgt_local,
                                mb + 1 + (f["b1"] & 63))),
        torch.where(io == 0, mb, io - 1))
    zero_hit = f["is_index"] & (target < 0)
    anchored_rgb = f["is_rgb"] | f["is_rgba"] | zero_hit | ~valid
    anchored_a = f["is_rgba"] | zero_hit | ~valid
    done0 = torch.stack([anchored_rgb] * 3 + [anchored_a], dim=1)
    lit = f["is_rgb"] | f["is_rgba"]
    anchor = torch.stack([
        torch.where(lit, f["b2"], 0), torch.where(lit, f["b3"], 0),
        torch.where(lit, f["b4"], 0), torch.where(f["is_rgba"], f["b5"], 0),
    ], dim=1).to(torch.uint8)
    delta = torch.stack([f["dr"], f["dg"], f["db"],
                         torch.zeros_like(f["dr"])], dim=1)
    parent = parent1.to(torch.int32)[:, None].expand(mb, 4)
    root, acc = link.resolve_roots(parent, delta, done0, _NSYM)
    root = root.to(torch.int64)
    real = root < mb
    base_val = torch.where(real, anchor.gather(0, root.clamp(max=mb - 1)), 0)

    # this rank's symbolic summary, 65 entries x 4 channels: the px after
    # its last chunk (or the incoming px passed through), and each table
    # slot's final value (its last local writer's, or passed through)
    last = max(nloc - 1, 0)
    if nloc > 0:
        px_root, px_acc, px_base = root[last], acc[last], base_val[last]
    else:
        px_root = torch.full((4,), mb, dtype=torch.int64, device=dev)
        px_acc = px_base = torch.zeros(4, dtype=torch.uint8, device=dev)
    wr_node = (loc_tbl - 1 - gid_base).clamp(0, mb - 1)
    w = loc_wr[:, None]
    sym = mb + 1 + torch.arange(64, device=dev)[:, None]
    sum_root = torch.cat([px_root[None], torch.where(w, root[wr_node], sym)])
    sum_acc = torch.cat([px_acc[None], torch.where(w, acc[wr_node], 0)])
    sum_base = torch.cat([px_base[None], torch.where(w, base_val[wr_node], 0)])
    acb = (sum_acc.to(torch.int64) | sum_base.to(torch.int64) << 8
           | (sum_root < mb).to(torch.int64) << 16)
    summ = ax.all_gather(torch.cat([sum_root, acb], dim=1))[:ax.index]
    summ = summ.to(dev)                                    # (index, 65, 8)

    # the S-step compose: the numeric value of every symbol entering
    # this rank
    numeric_in = torch.cat([
        torch.tensor(fmt.SEED_PIXEL, dtype=torch.uint8, device=dev)[None],
        torch.zeros((64, 4), dtype=torch.uint8, device=dev)])
    for s in summ:
        r, a = s[:, :4], (s[:, 4:] & 0xFF).to(torch.uint8)
        base, is_real = ((s[:, 4:] >> 8) & 0xFF).to(torch.uint8), \
            (s[:, 4:] >> 16) != 0
        numeric_in = torch.where(
            is_real, base + a,
            numeric_in.gather(0, (r - mb).clamp(0, _NSYM - 1)) + a)
    sym_idx = (root - mb).clamp(0, _NSYM - 1)
    return torch.where(real, base_val + acc,
                       numeric_in.gather(0, sym_idx) + acc)


def _tile_step(data: torch.Tensor, chunks_len: int,
               ax: "sharding.Axis") -> ShardOut:
    """The chunk-level decode of this rank's byte range: one shard of the
    JAX `_decode_tiled_device`, whose `conv` callers can assert. data:
    (Mb,) uint8, this rank's bytes of the chunk stream (the last range
    holds the trailer and zero padding); chunks_len: the stream's chunk
    bytes."""
    dev = data.device
    st = ax.stats
    with st.phase("decode fields and hashes", dev):
        f, valid, nloc, gid_base, pix_off, alpha_opt = _shard_fields(
            data, chunks_len, ax)
        hashes = _initial_hashes(f, valid, alpha_opt, ax)
    with st.phase("decode fixpoint", dev):
        conv, rounds = False, 0
        while not conv and rounds < _MAX_ITERS:
            px = _resolve(f, valid, hashes, gid_base, nloc, ax)
            true_h = torch.where(valid, table.hash64(px), 0)
            bad = ax.all_reduce((true_h != hashes).sum().reshape(1))
            conv = int(bad) == 0            # the same on every rank
            hashes = true_h
            rounds += 1
        if not conv:
            # the JAX loop's closing resolve from the last hashes (after a
            # converged round it gives the px already there)
            px = _resolve(f, valid, hashes, gid_base, nloc, ax)
    st.rounds.append(rounds)
    return ShardOut(px, f["npix"], pix_off, nloc, conv, rounds)


def _expand_tiled(px: torch.Tensor, pix_off: torch.Tensor, nloc: int,
                  ax: "sharding.Axis", n_px_cap: int) -> torch.Tensor:
    """The sharded run expansion. Each rank holds its chunks' px (Mb, 4)
    with GLOBAL pixel offsets: per-chunk mod-256 deltas against the
    previous chunk (the incoming px from the ranks before), scattered
    into the global delta plane, reduce-scattered onto each rank's pixel
    range, then a mod-256 prefix sum sharded over the ranks. Run
    interiors get no delta, so they repeat the chunk's px, and pixels past
    the last chunk keep its value (truncated streams).

    Returns this rank's (n_px_cap / S,) slice of the pixels, int64 u32
    r | g << 8 | b << 16 | a << 24."""
    mb = px.shape[0]
    dev = px.device
    io = torch.arange(mb, device=dev)
    valid = io < nloc
    p = px.to(torch.int64)
    has = torch.tensor(int(nloc > 0), device=dev)
    hl = ax.all_gather(torch.cat([p[max(nloc - 1, 0)], has[None]])).cpu()
    px_in = list(fmt.SEED_PIXEL)
    for row in hl[:ax.index].tolist():
        px_in = row[:4] if row[4] else px_in
    prev = torch.cat([torch.tensor(px_in, device=dev)[None], p[:-1]])
    d = torch.where(valid[:, None], (p - prev) & 0xFF, 0)     # (Mb, 4)
    d = d[:, 0] | d[:, 1] << 8 | d[:, 2] << 16 | d[:, 3] << 24

    # chunk pixel offsets are globally unique (a chunk emits >= 1 px), so
    # each pixel takes at most one packed delta word from one rank: the
    # sum over ranks never carries between bytes. A plain write, no
    # accumulation; offsets past the capacity and invalid slots go to a
    # spare entry
    keep = valid & (pix_off < n_px_cap)
    plane = torch.zeros(n_px_cap + 1, dtype=torch.int32, device=dev)
    plane[torch.where(keep, pix_off, n_px_cap)] = to_i32(d)
    loc = ax.reduce_scatter(plane[:n_px_cap])   # this rank's pixel range
    ch = (loc[None, :] >> torch.tensor([0, 8, 16, 24], device=dev)[:, None]
          ) & 0xFF                                               # (4, k)
    csum = torch.cumsum(ch.to(torch.int64), dim=1) & 0xFF
    tots = ax.all_gather(csum[:, -1]).cpu()                      # (S, 4)
    base = (tots[:ax.index].sum(dim=0) + torch.tensor(fmt.SEED_PIXEL)) & 0xFF
    v = (csum + base.to(dev)[:, None]) & 0xFF
    return v[0] | v[1] << 8 | v[2] << 16 | v[3] << 24


def _decode_expand_device(data: torch.Tensor, chunks_len: int,
                          ax: "sharding.Axis", n_px_cap: int
                          ) -> Tuple[torch.Tensor, bool]:
    """The sharded decode with the run expansion (one shard of the JAX
    `_decode_expand_device`): this rank's (n_px_cap / S,) int64 u32 pixel
    slice and the fixpoint's convergence (the same on every rank)."""
    out = _tile_step(data, chunks_len, ax)
    with ax.stats.phase("decode expand", data.device):
        px32 = _expand_tiled(out.px, out.pix_off, out.nloc, ax, n_px_cap)
    return px32, out.conv


def shard_bytes(data: bytes, ax: "sharding.Axis", device) -> Tuple:
    """This rank's byte range of a stream's chunk bytes: (data (Mb,) uint8
    on `device`, chunks_len, n_px_cap), with Mb = max(ceil(len/S), 8) and
    the pixel capacity a multiple of 64*S."""
    desc = fmt.unpack_header(data)
    body = np.frombuffer(data, np.uint8)[fmt.HEADER_SIZE:]
    chunks_len = len(data) - fmt.HEADER_SIZE - fmt.TRAILER_SIZE
    s = ax.size
    mb = max(-(-len(body) // s), 8)
    local = np.zeros((mb,), np.uint8)
    mine = body[ax.index * mb:(ax.index + 1) * mb]
    local[:len(mine)] = mine
    n_px_cap = -(-max(desc.num_pixels, 1) // (64 * s)) * 64 * s
    return torch.from_numpy(local).to(device), chunks_len, n_px_cap


def decode_tiled(data: bytes, mesh: "sharding.Mesh", channels: int = 0,
                 device="cuda") -> Tuple[np.ndarray, fmt.StreamDesc]:
    """Decode one stream with its bytes split over the seq axis of
    `mesh`; pixel-identical to the reference decoder (qoi.h:488). Every
    rank of the axis calls it with the same stream and returns the whole
    image. A stream whose sharded fixpoint does not converge goes to the
    v1 decoder on every rank."""
    if channels not in (0, 3, 4):
        raise ValueError(f"channels must be 0, 3 or 4, got {channels}")
    desc = fmt.unpack_header(data)
    out_ch = channels if channels else desc.channels
    ax = mesh.seq
    dev = sharding.rank_device(device)
    local, chunks_len, n_px_cap = shard_bytes(data, ax, dev)
    px32, conv = _decode_expand_device(local, chunks_len, ax, n_px_cap)
    if not conv:
        return dp.decode(data, channels, dev)
    flat = ax.all_gather(to_i32(px32).cpu()).numpy()    # on the host
    img = flat.reshape(-1).view(np.uint8).reshape(-1, 4)[:desc.num_pixels]
    return (np.ascontiguousarray(img[:, :out_ch]).reshape(
        desc.height, desc.width, out_ch), desc)
