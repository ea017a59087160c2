"""Inclusive scans of the decoders' associative combines: CUDA kernel
`csrc/blocked_scan.cu` (one pass, decoupled look-back) and their plain
twins.

Counterpart of qoi_tpu/ops/scans.py::blocked_scan (its lax.scan at :142)
for the combines the decode main path and v2 scan with it:

  fsm_scan        the chunk-start FSM (qoi_tpu/ops/fsm.py:82): (M,) uint8
                  chunk bytes -> (M,) int32 inclusive composed maps, the
                  leaf `_pack_map(chunk_byte_len(b) - 1)` built in place
  fsm_starts      the same scan applied to state 0, as
                  `chunk_starts_and_state` (qoi_tpu/ops/fsm.py:70-89):
                  (M,) bytes, chunks_len -> ((M,) bool starts, (M,) int8
                  state_before)
  initial_scan    `_initial_w`'s affine (alpha, hash) combine co-scanned
                  with the npix sum (qoi_tpu/models/decode_v3.py:197):
                  (M,) int32 leaves and npix -> (ps (M,) int32, inclusive
                  sum (M,) int64)
  initial_w_scan  the same scan from the (M,) bytes and starts, each leaf
                  built in the kernel as `_fields` and `_initial_leaf`
                  build it, applied to the entry px: (w, pix_off), (M,)
                  int64 each, as `decode_v3._initial_w` returns them
  anch_scan       `_anch_comb` (decode_v3.py:238, :266): (R, L) int32
                  leaves, each row scanned on its own -> (R, L) int32
  resolve_scan    v2's per-channel reset-or-add combine with the seed
                  epilogue (qoi_tpu/models/decode_v2.py:146-147): rflag
                  and val, (4, M) uint8 channel-major -> the (4, M) uint8
                  px after every byte

Each inclusive map is combine(earlier, later) folded from its row's
first element, which is its leaf unchanged. The twins are `assoc_scan`
with the combine, and for fsm_starts and initial_w_scan the plain
arithmetic around it. CPU tensors take the twin; CUDA tensors launch the
kernel or raise. Leaves are int32 bit patterns, read as u32.
"""
from __future__ import annotations

import torch

from .. import format as fmt
from .._bits import to_i32, u32
from ..ops.scans import assoc_scan
from . import _build
from .block_maps import _CLS_ADD, _CLS_ID, _CLS_INDEX, _CLS_RGB, _CLS_RGBA

#: elements a tile of the kernel (csrc/blocked_scan.cu: 512 threads x 32
#: FSM bytes, x 16 initial_w_scan bytes, x 8 initial_scan leaves, x 16
#: anch_scan leaves); a tile publishes one status word
TILE_FSM = 16384
TILE_BYTES = 8192
TILE_LEAVES = 4096
TILE_ANCH = 8192
#: positions a tile of the resolve scan (its own kernel,
#: `resolve_kernel`): 256 threads x two 16-position lanes
TILE_RESOLVE = 8192
#: longest bytes-form row: the status word holds a 40-bit npix sum, and
#: a chunk covers at most 62 pixels
MAX_BYTES = 1 << 34

_NSTATES = 5
_SEED_ALPHA = fmt.SEED_PIXEL[3]


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


def _hash_packed(px32: torch.Tensor) -> torch.Tensor:
    """(3r + 5g + 7b + 11a) & 63 from packed u32 (reference qoi.h:92)."""
    m = fmt.HASH_MULTIPLIERS
    return (m[0] * (px32 & 0xFF) + m[1] * ((px32 >> 8) & 0xFF)
            + m[2] * ((px32 >> 16) & 0xFF) + m[3] * ((px32 >> 24) & 0xFF)) & 63


_SEED_HASH = fmt.hash_rgba(*fmt.SEED_PIXEL)


def _shift_up(x: torch.Tensor, k: int) -> torch.Tensor:
    """x[i + k], zero past the end (all zero when x is shorter than k)."""
    return torch.cat([x[k:], x.new_zeros(min(k, x.shape[0]))])


def _chunk_fields(data: torch.Tensor, starts: torch.Tensor):
    """Per-byte chunk fields of `decode_v3._fields` from the bytes and the
    chunk starts. data: (M,) uint8. Returns (cls, r6, d32, lit32, npix),
    (M,) int64 each; the literals read 4 bytes ahead, zero past M."""
    d1 = data.to(torch.int64)
    b2, b3, b4, b5 = (_shift_up(d1, k) for k in (1, 2, 3, 4))

    is_rgb = (d1 == fmt.OP_RGB) & starts
    is_rgba = (d1 == fmt.OP_RGBA) & starts
    two = d1 & fmt.MASK_2
    other = ~is_rgb & ~is_rgba & starts
    is_index = other & (two == fmt.OP_INDEX)
    is_diff = other & (two == fmt.OP_DIFF)
    is_luma = other & (two == fmt.OP_LUMA)
    is_run = other & (two == fmt.OP_RUN)

    cls = torch.where(is_rgb, _CLS_RGB,
          torch.where(is_rgba, _CLS_RGBA,
          torch.where(is_index, _CLS_INDEX,
          torch.where(is_diff | is_luma | is_run, _CLS_ADD, _CLS_ID))))
    r6 = torch.where(is_index, d1 & 63, 0)
    npix = torch.where(is_run, (d1 & 0x3F) + 1, starts.to(torch.int64))

    # mod-256 deltas as the decoder applies them (reference qoi.h:562-572)
    dr = torch.where(is_diff, ((d1 >> 4) & 3) - 2, 0)
    dg2 = torch.where(is_diff, ((d1 >> 2) & 3) - 2, 0)
    db = torch.where(is_diff, (d1 & 3) - 2, 0)
    vg = (d1 & 0x3F) - 32
    lr = vg - 8 + ((b2 >> 4) & 0x0F)
    lb = vg - 8 + (b2 & 0x0F)
    dr = torch.where(is_luma, lr, dr) & 0xFF
    dg = torch.where(is_luma, vg, dg2) & 0xFF
    db = torch.where(is_luma, lb, db) & 0xFF
    d32 = dr | dg << 8 | db << 16
    lit32 = b2 | b3 << 8 | b4 << 16 | b5 << 24
    return cls, r6, d32, lit32, npix


def _initial_leaf(cls, r6, d32, lit32):
    """Packed affine leaf [ra:1 | g:1 | t:6 | e:6 | va:8] of
    `_initial_w`'s recurrence, (M,) int64: ID (g=1), ADD (g=1, e=dh),
    RGBA (e=habs; ra=1, va=alpha), RGB (t=11, e=c), INDEX (e=r6)."""
    m3, m5, m7, m11 = fmt.HASH_MULTIPLIERS
    is_rgba = cls == _CLS_RGBA
    is_rgb = cls == _CLS_RGB
    b2, b3 = lit32 & 0xFF, (lit32 >> 8) & 0xFF
    b4, b5 = (lit32 >> 16) & 0xFF, (lit32 >> 24) & 0xFF
    dh = (m3 * (d32 & 0xFF) + m5 * ((d32 >> 8) & 0xFF)
          + m7 * ((d32 >> 16) & 0xFF)) & 63
    habs = (m3 * b2 + m5 * b3 + m7 * b4 + m11 * b5) & 63
    c_rgb = (m3 * b2 + m5 * b3 + m7 * b4) & 63
    is_reset = is_rgb | is_rgba | (cls == _CLS_INDEX)
    g = (~is_reset).to(torch.int64)
    t = torch.where(is_rgb, m11 & 63, 0)
    e = torch.where(is_rgba, habs,
        torch.where(is_rgb, c_rgb,
        torch.where(cls == _CLS_INDEX, r6,
        torch.where(cls == _CLS_ADD, dh, 0))))
    return (is_rgba.to(torch.int64) | (g << 1) | (t << 2) | (e << 8)
            | (torch.where(is_rgba, b5, 0) << 14))


def _initial_apply(ps: torch.Tensor, inc: torch.Tensor, npix: torch.Tensor,
                   entry_px32=None):
    """`_initial_w`'s epilogue: the inclusive maps applied to the entry
    px's hash and alpha (0-d int64 u32, default the seed), and the
    exclusive npix sum. Returns (w, pix_off), (M,) int64 each."""
    if entry_px32 is None:
        h0, a0 = _SEED_HASH, _SEED_ALPHA
    else:
        h0, a0 = _hash_packed(entry_px32), (entry_px32 >> 24) & 0xFF
    ps = ps.to(torch.int64)
    gs, ts_, es = (ps >> 1) & 1, (ps >> 2) & 63, (ps >> 8) & 63
    return (gs * h0 + ts_ * a0 + es) & 63, inc - npix.to(torch.int64)


def fsm_scan_plain(data: torch.Tensor) -> torch.Tensor:
    """Plain twin of fsm_scan: log-depth `assoc_scan` of the maps."""
    return assoc_scan(_compose_maps,
                      _pack_map(chunk_byte_len(data) - 1)).to(torch.int32)


def fsm_starts_plain(data: torch.Tensor, chunks_len):
    """Plain twin of fsm_starts: the maps' state 0 digit, one byte late
    (0 before byte 0), and the `p < chunks_len` guard."""
    after = fsm_scan_plain(data)
    m = data.shape[0]
    state_before = torch.zeros(m, dtype=torch.int8, device=data.device)
    state_before[1:] = (after[:-1] & 7).to(torch.int8)
    io = torch.arange(m, device=data.device)
    return (state_before == 0) & (io < chunks_len), state_before


def initial_scan_plain(leaf: torch.Tensor, npix: torch.Tensor):
    """Plain twin of initial_scan."""
    ps, inc = assoc_scan(
        lambda a, b: (_initial_comb(a[0], b[0]), a[1] + b[1]),
        (u32(leaf), npix.to(torch.int64)))
    return to_i32(ps), inc


def initial_w_scan_plain(data: torch.Tensor, starts: torch.Tensor,
                         entry_px32=None):
    """Plain twin of initial_w_scan: the fields, the leaf, the scan and
    the epilogue in plain torch."""
    cls, r6, d32, lit32, npix = _chunk_fields(data, starts)
    ps, inc = initial_scan_plain(
        _initial_leaf(cls, r6, d32, lit32).to(torch.int32),
        npix.to(torch.int32))
    return _initial_apply(ps, inc, npix, entry_px32)


def anch_scan_plain(leaf: torch.Tensor) -> torch.Tensor:
    """Plain twin of anch_scan, along the last axis."""
    return to_i32(assoc_scan(_anch_comb, u32(leaf)))


def _resolve_comb(a, b):
    """v2's reset-or-add, b after a: (max(ra, rb), vb where rb else va +
    vb mod 256), on uint8 (flag, value) pairs."""
    (ra, va), (rb, vb) = a, b
    return torch.maximum(ra, rb), torch.where(rb != 0, vb, va + vb)


def resolve_scan_plain(rflag: torch.Tensor,
                       val: torch.Tensor) -> torch.Tensor:
    """Plain twin of resolve_scan: log-depth `assoc_scan` of the combine,
    then the seed added where no reset came."""
    rs, vs = assoc_scan(_resolve_comb, (rflag, val))
    seed = torch.tensor(fmt.SEED_PIXEL, dtype=torch.uint8,
                        device=vs.device)[:, None]
    return torch.where(rs != 0, vs, seed + vs)


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


def _scratch(rows: int, length: int, tile: int, sums: bool,
             dev: torch.device) -> torch.Tensor:
    """The kernel's look-back scratch (the C entry zeroes it on the stream
    before each launch): a ticket, a status word a tile and, for the leaf
    form, two int64 sums a tile."""
    blocks = rows * -(-length // tile)
    return torch.empty(1 + blocks * (3 if sums else 1), dtype=torch.int64,
                       device=dev)


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
            _scratch(1, m, TILE_FSM, False, data.device).data_ptr(), m,
            _build.stream_ptr(data.device))
    _build.launched("fsm_scan", rc)
    return out


def fsm_starts(data: torch.Tensor, chunks_len):
    """(M,) uint8 chunk bytes -> ((M,) bool starts, (M,) int8
    state_before): how many bytes of the current chunk precede byte i (0:
    i starts a chunk), and starts = state_before == 0 below chunks_len."""
    _check("fsm_starts", torch.uint8, 1, data)
    if data.device.type == "cpu":
        return fsm_starts_plain(data, chunks_len)
    _build.check_cuda("fsm_starts", data, dtype=torch.uint8)
    m = data.shape[0]
    starts = torch.empty(m, dtype=torch.bool, device=data.device)
    state = torch.empty(m, dtype=torch.int8, device=data.device)
    if m == 0:
        return starts, state
    with torch.cuda.device(data.device):
        rc = _build.lib().qoi_fsm_starts(
            data.data_ptr(), starts.data_ptr(), state.data_ptr(),
            _scratch(1, m, TILE_FSM, False, data.device).data_ptr(), m,
            int(chunks_len), _build.stream_ptr(data.device))
    _build.launched("fsm_starts", rc)
    return starts, state


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
            _scratch(1, m, TILE_LEAVES, True, dev).data_ptr(), m,
            _build.stream_ptr(dev))
    _build.launched("initial_scan", rc)
    return ps, inc


def initial_w_scan(data: torch.Tensor, starts: torch.Tensor,
                   entry_px32=None):
    """(M,) uint8 chunk bytes and (M,) bool chunk starts -> (w, pix_off),
    (M,) int64 each: `decode_v3._initial_w` of the bytes' fields, the
    leaves built in the kernel. `entry_px32` (0-d int64 u32 on the same
    device, default the seed) is read on the device."""
    _check("initial_w_scan", torch.uint8, 1, data)
    _check("initial_w_scan", torch.bool, 1, starts)
    if starts.shape != data.shape or starts.device != data.device:
        raise ValueError("initial_w_scan: data and starts differ in shape "
                         "or device")
    if entry_px32 is not None and (
            entry_px32.dtype != torch.int64 or entry_px32.numel() != 1
            or entry_px32.device != data.device):
        raise ValueError("initial_w_scan: entry_px32 must be one int64 "
                         "on the data's device")
    if data.device.type == "cpu":
        return initial_w_scan_plain(data, starts, entry_px32)
    _build.check_cuda("initial_w_scan", data, dtype=torch.uint8)
    _build.check_cuda("initial_w_scan", starts, dtype=torch.bool)
    m = data.shape[0]
    if m > MAX_BYTES:
        raise ValueError(f"initial_w_scan: {m} bytes, the kernel takes at "
                         f"most {MAX_BYTES}")
    dev = data.device
    w = torch.empty(m, dtype=torch.int64, device=dev)
    pix_off = torch.empty(m, dtype=torch.int64, device=dev)
    if m == 0:
        return w, pix_off
    with torch.cuda.device(dev):
        rc = _build.lib().qoi_initial_w(
            data.data_ptr(), starts.data_ptr(),
            None if entry_px32 is None else entry_px32.data_ptr(),
            w.data_ptr(), pix_off.data_ptr(),
            _scratch(1, m, TILE_BYTES, False, dev).data_ptr(), m,
            _build.stream_ptr(dev))
    _build.launched("initial_w_scan", rc)
    return w, pix_off


def anch_scan(leaf: torch.Tensor) -> torch.Tensor:
    """(R, L) int32 (g, e) leaves -> (R, L) int32, each row's inclusive
    scan."""
    _check("anch_scan", torch.int32, 2, leaf)
    if leaf.device.type == "cpu":
        return anch_scan_plain(leaf)
    _build.check_cuda("anch_scan", leaf)
    rows, length = leaf.shape
    out = torch.empty_like(leaf)
    if leaf.numel() == 0:
        return out
    with torch.cuda.device(leaf.device):
        rc = _build.lib().qoi_anch_scan(
            leaf.data_ptr(), out.data_ptr(),
            _scratch(rows, length, TILE_ANCH, False,
                     leaf.device).data_ptr(), rows, length,
            _build.stream_ptr(leaf.device))
    _build.launched("anch_scan", rc)
    return out


def resolve_scan(rflag: torch.Tensor, val: torch.Tensor) -> torch.Tensor:
    """(4, M) uint8 reset flags and values, channel-major -> (4, M) uint8
    px after every byte: where a reset came at or before it, the value
    after the last one plus the adds since, mod 256; else the seed's
    channel plus every add."""
    _check("resolve_scan", torch.uint8, 2, rflag, val)
    if rflag.shape[0] != 4:
        raise ValueError(f"resolve_scan: {rflag.shape[0]} channels, want 4")
    if rflag.device.type == "cpu":
        return resolve_scan_plain(rflag, val)
    _build.check_cuda("resolve_scan", rflag, val, dtype=torch.uint8)
    m = rflag.shape[1]
    dev = rflag.device
    out = torch.empty((4, m), dtype=torch.uint8, device=dev)
    if m == 0:
        return out
    with torch.cuda.device(dev):
        rc = _build.lib().qoi_resolve_scan(
            rflag.data_ptr(), val.data_ptr(), out.data_ptr(),
            _scratch(1, m, TILE_RESOLVE, False, dev).data_ptr(), m,
            _build.stream_ptr(dev))
    _build.launched("resolve_scan", rc)
    return out
