"""One sharded encode and decode step over a (data, seq) mesh of every
rank: the port's counterpart of `__graft_entry__.dryrun_multichip`.

Every rank of an initialized process group of n ranks calls
`dryrun_multichip(n)`. The mesh is (2, n/2) for an even n >= 4, else
(1, n): images data-parallel, the pixel tiles of each stream
sequence-parallel. Each data index encodes two streams of seq*128 - 7
pixels (a Python loop where the JAX package maps), one all_reduce over
both axes sums the grand total, and the stream offsets must be the
exclusive prefix of the tiles' totals. The decode half runs the sharded
fixpoint and expansion directly (`decode_tiled` would fall back to v1 on
non-convergence and hide a broken sharded resolve), asserts `conv` on
every shard, and checks the pixels against the source.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import format as fmt
from ..models import scan_codec
from . import sharding, tiled, tiled_decode

_TILE = 128


def _check(ok: bool, msg: str) -> None:
    if not ok:
        raise AssertionError(f"dryrun_multichip: {msg}")


def dryrun_multichip(n_devices: int, device="cuda") -> dict:
    """Run the step on this rank; returns what it checked (totals,
    offsets, the grand total, the decode's convergence)."""
    if n_devices >= 4 and n_devices % 2 == 0:
        data, seq = 2, n_devices // 2
    else:
        data, seq = 1, n_devices
    mesh = sharding.make_mesh(data, seq, device)
    dev = mesh.device
    ax = mesh.seq
    n_px = seq * _TILE - 7   # a trailing pad exercises the n_valid path
    batch = data * 2

    rng = np.random.default_rng(1)
    px = np.zeros((batch, seq * _TILE, 4), np.uint8)
    px[:, :n_px] = rng.integers(0, 256, size=(batch, n_px, 4), dtype=np.uint8)
    mine = range(mesh.data.index * 2, mesh.data.index * 2 + 2)
    outs = [tiled._tile_step(
        torch.from_numpy(px[i, ax.index * _TILE:(ax.index + 1) * _TILE])
        .to(dev), n_px, ax) for i in mine]
    local = sum(o.total for o in outs)
    grand = int(mesh.world.all_reduce(
        torch.tensor([local], dtype=torch.int64, device=dev)))
    # every stream's tile totals, from the data axis
    totals = mesh.data.all_gather(torch.tensor(
        [o.totals for o in outs], device=dev)).reshape(batch, seq).cpu()
    for o in outs:
        _check(o.buf.shape == (_TILE * 6,), f"tile buffer {o.buf.shape}")
        _check(o.offset == sum(o.totals[:ax.index]),
               "an offset is not the exclusive prefix of the totals")
    _check(grand == int(totals.sum()) > 0,
           f"grand total {grand} != the sum of the totals {totals}")

    # ---- decode half: the sharded fixpoint and expansion, directly -------
    w, h = 40, 13
    img = rng.integers(0, 256, size=(h, w, 4), dtype=np.uint8)
    img[3:7] = img[2]        # runs and table hits cross the shards
    img[8:10, :, 3] = 255    # alpha-toggling rows: RGBA literals and the
    img[10, :, 3] = 7        # alpha-coupled written-slot estimate
    stream = scan_codec.encode(img, fmt.StreamDesc(w, h, 4), dev)
    local_bytes, chunks_len, n_px_cap = tiled_decode.shard_bytes(
        stream, ax, dev)
    px32, conv = tiled_decode._decode_expand_device(
        local_bytes, chunks_len, ax, n_px_cap)
    convs = mesh.world.all_gather(torch.tensor([int(conv)], device=dev))
    _check(bool(convs.all()), "the sharded decode fixpoint did not converge")
    flat = ax.all_gather(px32.to(torch.int64)).cpu().numpy().astype(np.uint32)
    dec = flat.reshape(-1).view(np.uint8).reshape(-1, 4)[: w * h]
    _check(np.array_equal(dec.reshape(h, w, 4), img),
           "the sharded decode's pixels differ from the source")
    return dict(mesh=(data, seq), totals=totals.tolist(), grand=grand,
                conv=[bool(c) for c in convs.reshape(-1).tolist()])
