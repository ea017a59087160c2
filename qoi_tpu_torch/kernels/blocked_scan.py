"""Inclusive scans of the decoder's three associative combines: CUDA
kernel `csrc/blocked_scan.cu` and their plain twins.

Counterpart of qoi_tpu/ops/scans.py::blocked_scan (its lax.scan at :142)
for the combines the decode main path scans with it:

  fsm_scan      the chunk-start FSM (qoi_tpu/ops/fsm.py:82): (M,) uint8
                chunk bytes -> (M,) int32 inclusive composed maps, the
                leaf `_pack_map(chunk_byte_len(b) - 1)` built in place
  initial_scan  `_initial_w`'s affine (alpha, hash) combine co-scanned
                with the npix sum (qoi_tpu/models/decode_v3.py:197):
                (M,) int32 leaves and npix -> (ps (M,) int32, inclusive
                sum (M,) int64)
  anch_scan     `_anch_comb` (decode_v3.py:238, :266): (R, L) int32
                leaves, each row scanned on its own -> (R, L) int32

Each output element is combine(earlier, later) folded from its row's
first element, which is its leaf unchanged. The twins are `assoc_scan`
with the combine. CPU tensors take the twin; CUDA tensors launch the
kernel or raise. Leaves are int32 bit patterns, read as u32.
"""
from __future__ import annotations

import torch

from .. import format as fmt
from .._bits import to_i32, u32
from ..ops.scans import assoc_scan
from . import _build

#: elements a tile of the kernel (csrc/blocked_scan.cu kTile: 256
#: threads x 16); a row of L elements keeps ceil(L / TILE) - 1 tile
#: aggregates in the scratch
TILE = 4096
#: rows a launch takes (the grid's y dimension)
MAX_ROWS = 65535

_NSTATES = 5


def chunk_byte_len(b: torch.Tensor) -> torch.Tensor:
    """Chunk length implied by a first byte (reference qoi.h:547-575)."""
    b = b.to(torch.int64)
    return torch.where(b == fmt.OP_RGB, 4,
           torch.where(b == fmt.OP_RGBA, 5,
           torch.where((b & fmt.MASK_2) == fmt.OP_LUMA, 2, 1)))


def _pack_map(f0: torch.Tensor) -> torch.Tensor:
    """Pack the 5-state map [f0, 0, 1, 2, 3] into base-8 digits: digit s
    holds f(s). Only state 0's transition depends on the byte."""
    const = 0
    for s in range(1, _NSTATES):
        const |= (s - 1) << (3 * s)
    return f0.to(torch.int64) | const


def _compose_maps(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """b after a: c[s] = b[a[s]], on base-8-packed maps (elementwise)."""
    c = torch.zeros_like(a)
    for s in range(_NSTATES):
        a_s = (a >> (3 * s)) & 7
        c = c | (((b >> (3 * a_s)) & 7) << (3 * s))
    return c


def _initial_comb(p1, p2):
    """Compose two packed affine (alpha, hash) maps, p2 after p1."""
    ra1, g1 = p1 & 1, (p1 >> 1) & 1
    t1, e1, va1 = (p1 >> 2) & 63, (p1 >> 8) & 63, (p1 >> 14) & 0xFF
    ra2, g2 = p2 & 1, (p2 >> 1) & 1
    t2, e2, va2 = (p2 >> 2) & 63, (p2 >> 8) & 63, (p2 >> 14) & 0xFF
    g = g1 & g2
    t = (g2 * t1 + (1 - ra1) * t2) & 63
    e = (g2 * e1 + e2 + ra1 * t2 * va1) & 63
    va = torch.where(ra2 != 0, va2, va1)
    return (ra1 | ra2) | (g << 1) | (t << 2) | (e << 8) | (va << 14)


def _anch_comb(p1, p2):
    """Compose two packed (g, e) maps h' = g*h + e mod 64, p2 after p1."""
    g1, e1 = p1 & 1, p1 >> 1
    g2, e2 = p2 & 1, p2 >> 1
    return (g1 & g2) | (((g2 * e1 + e2) & 63) << 1)


def fsm_scan_plain(data: torch.Tensor) -> torch.Tensor:
    """Plain twin of fsm_scan: log-depth `assoc_scan` of the maps."""
    return assoc_scan(_compose_maps,
                      _pack_map(chunk_byte_len(data) - 1)).to(torch.int32)


def initial_scan_plain(leaf: torch.Tensor, npix: torch.Tensor):
    """Plain twin of initial_scan."""
    ps, inc = assoc_scan(
        lambda a, b: (_initial_comb(a[0], b[0]), a[1] + b[1]),
        (u32(leaf), npix.to(torch.int64)))
    return to_i32(ps), inc


def anch_scan_plain(leaf: torch.Tensor) -> torch.Tensor:
    """Plain twin of anch_scan, along the last axis."""
    return to_i32(assoc_scan(_anch_comb, u32(leaf)))


def _check(name: str, dtype: torch.dtype, ndim: int, *tensors) -> None:
    """Raise unless the tensors share one shape of `ndim` dims, have
    `dtype` and lie on one device."""
    t0 = tensors[0]
    for t in tensors:
        if t.dtype != dtype:
            raise TypeError(f"{name}: dtype {t.dtype}, want {dtype}")
        if t.dim() != ndim or t.shape != t0.shape:
            raise ValueError(f"{name}: want {ndim}-d tensors of one shape, "
                             f"got {[tuple(x.shape) for x in tensors]}")
        if t.device != t0.device:
            raise ValueError(f"{name}: tensors on {t0.device} and "
                             f"{t.device}")


def _scratch(rows: int, length: int, dev: torch.device) -> torch.Tensor:
    """The kernel's tile aggregates: a u64 sum and a u32 map each."""
    na = rows * max(-(-length // TILE) - 1, 0)
    return torch.empty(max(3 * na, 1), dtype=torch.int32, device=dev)


def fsm_scan(data: torch.Tensor) -> torch.Tensor:
    """(M,) uint8 chunk bytes -> (M,) int32 inclusive composed FSM maps
    (digit s of element i: the state after byte i from state s)."""
    _check("fsm_scan", torch.uint8, 1, data)
    if data.device.type == "cpu":
        return fsm_scan_plain(data)
    _build.check_cuda("fsm_scan", data, dtype=torch.uint8)
    m = data.shape[0]
    out = torch.empty(m, dtype=torch.int32, device=data.device)
    if m == 0:
        return out
    with torch.cuda.device(data.device):
        rc = _build.lib().qoi_fsm_scan(
            data.data_ptr(), out.data_ptr(),
            _scratch(1, m, data.device).data_ptr(), m,
            _build.stream_ptr(data.device))
    _build.launched("fsm_scan", rc)
    return out


def initial_scan(leaf: torch.Tensor, npix: torch.Tensor):
    """(M,) int32 packed affine leaves and (M,) int32 npix -> (ps (M,)
    int32 inclusive composed maps, (M,) int64 inclusive npix sum)."""
    _check("initial_scan", torch.int32, 1, leaf, npix)
    if leaf.device.type == "cpu":
        return initial_scan_plain(leaf, npix)
    _build.check_cuda("initial_scan", leaf, npix)
    m = leaf.shape[0]
    dev = leaf.device
    ps = torch.empty(m, dtype=torch.int32, device=dev)
    inc = torch.empty(m, dtype=torch.int64, device=dev)
    if m == 0:
        return ps, inc
    with torch.cuda.device(dev):
        rc = _build.lib().qoi_initial_scan(
            leaf.data_ptr(), npix.data_ptr(), ps.data_ptr(), inc.data_ptr(),
            _scratch(1, m, dev).data_ptr(), m, _build.stream_ptr(dev))
    _build.launched("initial_scan", rc)
    return ps, inc


def anch_scan(leaf: torch.Tensor) -> torch.Tensor:
    """(R, L) int32 (g, e) leaves -> (R, L) int32, each row's inclusive
    scan (R <= MAX_ROWS on the card)."""
    _check("anch_scan", torch.int32, 2, leaf)
    if leaf.device.type == "cpu":
        return anch_scan_plain(leaf)
    _build.check_cuda("anch_scan", leaf)
    rows, length = leaf.shape
    if rows > MAX_ROWS:
        raise ValueError(f"anch_scan: {rows} rows, the kernel takes at "
                         f"most {MAX_ROWS}")
    out = torch.empty_like(leaf)
    if leaf.numel() == 0:
        return out
    with torch.cuda.device(leaf.device):
        rc = _build.lib().qoi_anch_scan(
            leaf.data_ptr(), out.data_ptr(),
            _scratch(rows, length, leaf.device).data_ptr(), rows, length,
            _build.stream_ptr(leaf.device))
    _build.launched("anch_scan", rc)
    return out
