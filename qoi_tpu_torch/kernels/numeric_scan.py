"""Decode pass 3 as a numeric re-scan: CUDA kernel `csrc/numeric_scan.cu`
and its plain twin.

Counterpart of the `lax.scan` in qoi_tpu/models/decode_v3.py::_numeric_scan,
the pass 3 of `_resolve_p(apply="scan")`. Inputs are the position-major
(b, nb) int32 planes of pass 1 (meta = cls | w << 3 | r6 << 9, d32, lit32,
u32 bit patterns) and the (65, nb) numeric entry state of every block lane
from pass 2 (row 0 the px, row 1+s slot s). Each lane walks its b
positions from its entry state; a live step (cls != 0) sets px by the
selects of `block_maps._step_val` and writes it to slot w.

Returns (px (b, nb), exit65 (65,)), int32 bit patterns: the px after every
position, and the state (px, slots) after the LAST lane's last position,
the stream's exit state.

The kernel (csrc/numeric_scan.cu) is bound by bytes on the H100 (16 B a
position: 235 MB, 0.070 ms at 4K). Walked one step at a time, a lane is a
chain of b dependent steps through its slot table, and that chain, not the
bytes, would set the time. An INDEX writes back the slot it read, so it
takes the px of the last earlier live non-INDEX step of its slot, and every
other step is a map of px that composes: the kernel gives each lane a warp
that resolves 32 positions a window (a segmented scan of the maps, the
INDEX values as fixpoint rounds of shuffles, the slot table in shared
memory), and each block of 8 lanes reads the position-major planes as
whole rows through a cp.async ring of tiles. On the card the window's
instructions (the scan's shuffle steps first), not the bytes, bound the
redesigned kernel (PERF.md). The twin is a Python loop over the b
positions, each step vectorized over the nb lanes.
"""
from __future__ import annotations

import torch

from .._bits import to_i32, u32
from . import _build
from .block_maps import _CLS_ID, _step_val


def numeric_scan_plain(meta: torch.Tensor, d32: torch.Tensor,
                       lit32: torch.Tensor, entry: torch.Tensor):
    """Plain PyTorch twin: the JAX scan body, one step a position. An
    INDEX reads and writes the same slot w, so one gather serves both."""
    b, _ = meta.shape
    meta = meta.to(torch.int64)
    d32, lit32, entry = u32(d32), u32(lit32), u32(entry)
    px = entry[0].clone()
    tval = entry[1:].clone()
    out = torch.empty(meta.shape, dtype=torch.int64, device=meta.device)
    for i in range(b):
        cls = meta[i] & 7
        w = ((meta[i] >> 3) & 63)[None]
        src = tval.gather(0, w)[0]
        new = _step_val(cls, d32[i], lit32[i], px, src)
        live = cls != _CLS_ID
        px = torch.where(live, new, px)
        tval.scatter_(0, w, torch.where(live, new, src)[None])
        out[i] = px
    return to_i32(out), to_i32(torch.cat([px[-1:], tval[:, -1]]))


def numeric_scan(meta: torch.Tensor, d32: torch.Tensor, lit32: torch.Tensor,
                 entry: torch.Tensor):
    """Pass 3 as a re-scan. CPU tensors take the plain twin; CUDA tensors
    launch the kernel (or raise)."""
    if not (meta.shape == d32.shape == lit32.shape) or meta.dim() != 2:
        raise ValueError("numeric_scan: want three equal (b, nb) planes")
    b, nb = meta.shape
    if tuple(entry.shape) != (65, nb):
        raise ValueError(f"numeric_scan: entry {tuple(entry.shape)}, want "
                         f"(65, {nb})")
    if all(t.device.type == "cpu" for t in (meta, d32, lit32, entry)):
        return numeric_scan_plain(meta, d32, lit32, entry)
    _build.check_cuda("numeric_scan", meta, d32, lit32, entry)
    dev = meta.device
    px = torch.empty((b, nb), dtype=torch.int32, device=dev)
    exit65 = torch.empty(65, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        rc = _build.lib().qoi_numeric_scan(
            meta.data_ptr(), d32.data_ptr(), lit32.data_ptr(),
            entry.data_ptr(), px.data_ptr(), exit65.data_ptr(), b, nb,
            _build.stream_ptr(dev))
    _build.launched("numeric_scan", rc)
    return px, exit65
