"""Encode staging: CUDA kernels `csrc/encode_stage.cu` and their plain
twins, in three forms.

Bytes form (port of qoi_tpu/kernels/encode_stage.py::encode_stage_pallas):
encoder stages 1-4 in one pass, px4 (N, 4) uint8 -> (staging (N, 6)
uint8, lens (N, 1) int32), with staged bytes at or past each length
zeroed. The JAX kernel walks 1024-pixel blocks in order, carrying the
previous pixel, the run phase and the colour table; the CUDA kernel
computes those carries instead, in one launch, by decoupled look-back
(see its header). `last_pos` is the global index of the stream's final
pixel (default n_valid - 1) or -1. As in the JAX kernel the pending run
is cut to 0 at every block start after the block that holds last_pos --
past the stream's end for the default, so only a last_pos below
n_valid - 1 shows the 1024-pixel block in the result.

Words form (`encode_stage_words`, the encode main path's staging): the
JAX `encode_stage_chunks(form="words")` with its tile carries in and
out, whose run segmentation (a cummax) and table carry (an overwrite
scan) are `blocked_scan`s in the JAX package (qoi_tpu/ops/scans.py:102),
in one launch of the same kernel design: any N >= 1, no run cut, the
incoming carry as a virtual tile before tile 0. Its kernel takes tiles of
4096 pixels, each thread two lanes of four consecutive pixels (see the
kernel's header).

Planes form (`encode_stage_planes`, the pack encode's staging): the JAX
`encode_stage_chunks(form="bytes")` with the same carries, the (6, N)
byte planes written plane-major by the same kernel: a record's bytes,
0 past its length, but every eq position keeps its run byte in plane 0
(the fused form zeroes it), as the JAX planes do.
"""
from __future__ import annotations

from typing import Optional

import torch

from .._bits import to_i32, u32
from ..models import pipeline
from . import _build

#: pixels per block of the fused form, the JAX kernel's default block
_BLOCK = 1024
#: pixels per tile of the words and planes forms (512 threads x 2 lanes
#: x 4 pixels)
_TILE = 4096
#: look-back columns: the 64 slots and the last literal
_COLS = 65


def _run_resets(n: int, n_valid: int, last_pos: int,
                device) -> torch.Tensor:
    """(N,) bool: block starts where the JAX kernel's run carry is 0
    (encode_stage.py:216): after a block whose valid region ends past
    last_pos."""
    io = torch.arange(n, device=device)
    lim = torch.minimum(torch.clamp(io - _BLOCK, min=n_valid), io)
    return (io % _BLOCK == 0) & (io > 0) & (last_pos < lim)


def encode_stage_plain(px4: torch.Tensor, n_valid: int,
                       last_pos: Optional[int] = None):
    """Plain PyTorch twin: the port's encode_stage_chunks(form="bytes")
    with the kernel's last_pos and run cuts, staging transposed to (N, 6)
    and zeroed at or past each length."""
    n = px4.shape[0]
    last_pos = n_valid - 1 if last_pos is None else last_pos
    ch = pipeline.encode_stage_chunks(
        px4, n_valid, form="bytes", last_pos=last_pos,
        run_resets=_run_resets(n, n_valid, last_pos, px4.device))
    col = torch.arange(6, device=px4.device)[None, :]
    stag = torch.where(col < ch.lens[:, None], ch.staging.T, 0)
    return (stag.to(torch.uint8).contiguous(),
            ch.lens.to(torch.int32)[:, None].contiguous())


def encode_stage_pallas(px4: torch.Tensor, n_valid,
                        last_pos: Optional[int] = None):
    """Fused staging (name kept from the JAX package): px4 (N, 4) uint8,
    N a multiple of 1024 -> (staging (N, 6) uint8, lens (N, 1) int32).
    CPU tensors take the plain twin; CUDA tensors launch the kernel (or
    raise)."""
    if px4.dim() != 2 or px4.shape[1] != 4:
        raise ValueError(f"encode_stage: px4 shape {tuple(px4.shape)}, "
                         "want (N, 4)")
    n = px4.shape[0]
    if n % _BLOCK:
        raise ValueError(f"encode_stage: N = {n}; pad the pixel count to "
                         f"a multiple of {_BLOCK}")
    n_valid = int(n_valid)
    if n_valid < 0:
        raise ValueError(f"encode_stage: n_valid {n_valid} < 0")
    last_pos = n_valid - 1 if last_pos is None else int(last_pos)
    if px4.device.type == "cpu":
        return encode_stage_plain(px4, n_valid, last_pos)
    _build.check_cuda("encode_stage", px4, dtype=torch.uint8)
    if px4.data_ptr() % 4:
        raise ValueError("encode_stage: px4 must be 4-byte aligned")
    dev = px4.device
    stag = torch.empty((n, 6), dtype=torch.uint8, device=dev)
    lens = torch.empty((n, 1), dtype=torch.int32, device=dev)
    if n == 0:
        return stag, lens
    # the ticket, then 65 look-back status words a block, zeroed by the C
    # entry before the launch
    scratch = torch.empty(1 + _COLS * (n // _BLOCK), dtype=torch.int64,
                          device=dev)
    with torch.cuda.device(dev):
        rc = _build.lib().qoi_encode_stage(
            px4.data_ptr(), stag.data_ptr(), lens.data_ptr(),
            scratch.data_ptr(), n, min(n_valid, n), last_pos,
            _build.stream_ptr(dev))
    _build.launched("encode_stage", rc)
    return stag, lens


#: the seed pixel (0, 0, 0, 255) packed r | g << 8 | b << 16 | a << 24,
#: as an int32 bit pattern
_SEED32 = 0xFF000000 - (1 << 32)


def _carry_args(n: int, n_valid, prev_in, run_in, table_in, contains_last,
                dev):
    """The words kernel's carry in, from Python values or tensors, with
    no host read: (header, from_dev, carry_in). header: the five int32
    values n_valid, the carry's pixel count, run_in, prev_in packed and
    contains_last (csrc/encode_stage.cu, kIn*), launch arguments; the
    fields given as tensors are instead written to carry_in, a (133,)
    int32 tensor on `dev` (None when nothing is), and marked in the bit
    mask from_dev, whose bit 5 marks table_in[64] and written_in[64]
    there. contains_last is 0 or 1, and 2 when not given (the last pixel
    is here, yet the run goes out in the carry, as the JAX function
    leaves it). The carry's pixel count is n_valid or, as the JAX function
    takes it when n_valid is not given, N where the tile holds the last
    pixel and 0 where it does not."""
    last = 2 if contains_last is None else contains_last
    if n_valid is None:
        n_valid, count = n, (torch.where(last.to(dev), n, 0)
                             if isinstance(last, torch.Tensor)
                             else n * bool(last))
    else:
        count = n_valid
    if prev_in is not None:
        # a fresh copy, so that its 4 bytes read as one aligned word
        prev_in = prev_in.to(dev, torch.uint8).clone().view(torch.int32)
    fields = [n_valid, count, 0 if run_in is None else run_in,
              _SEED32 if prev_in is None else prev_in, last]
    header = [0 if isinstance(x, torch.Tensor) else int(x) for x in fields]
    header[4] = min(header[4], 2)
    from_dev = sum(1 << k for k, x in enumerate(fields)
                   if isinstance(x, torch.Tensor))
    if table_in is not None:
        from_dev |= 1 << 5
    if not from_dev:
        return header, 0, None
    cin = torch.zeros(5 + 2 * 64, dtype=torch.int32, device=dev)
    for k, x in enumerate(fields):
        if isinstance(x, torch.Tensor):
            x = x.to(dev).reshape(-1).long()
            cin[k:k + 1] = x.clamp(0, 2) if k == 4 else to_i32(u32(x))
    if table_in is not None:
        cin[5:69] = to_i32(u32(table_in[0].to(dev)))
        cin[69:] = table_in[1].to(dev)
    return header, from_dev, cin


def encode_stage_words_plain(px4: torch.Tensor, n_valid=None, prev_in=None,
                             run_in=None, table_in=None,
                             contains_last=None) -> pipeline.EncodedWords:
    """Plain PyTorch twin: the port's encode_stage_chunks(form="words")
    in plain torch, lo, hi and lens as the kernel's int32."""
    ch = pipeline.stage_chunks_plain(
        px4, n_valid, prev_in=prev_in, run_in=run_in, table_in=table_in,
        contains_last=contains_last, form="words")
    return pipeline.EncodedWords(to_i32(ch.lo), to_i32(ch.hi),
                                 ch.lens.to(torch.int32), ch.carry)


def encode_stage_planes_plain(px4: torch.Tensor, n_valid=None,
                              prev_in=None, run_in=None, table_in=None,
                              contains_last=None) -> pipeline.EncodedChunks:
    """Plain PyTorch twin: the port's encode_stage_chunks(form="bytes")
    in plain torch, lens as the kernel's int32."""
    ch = pipeline.stage_chunks_plain(
        px4, n_valid, prev_in=prev_in, run_in=run_in, table_in=table_in,
        contains_last=contains_last, form="bytes")
    return pipeline.EncodedChunks(ch.staging, ch.lens.to(torch.int32),
                                  ch.carry)


def _check_carry_form(name: str, px4: torch.Tensor, n_valid) -> int:
    """Raise unless px4 is (N, 4) with N >= 1 and a given n_valid lies in
    [0, N]; returns N."""
    if px4.dim() != 2 or px4.shape[1] != 4:
        raise ValueError(f"{name}: px4 shape {tuple(px4.shape)}, want "
                         "(N, 4)")
    n = px4.shape[0]
    if n == 0:
        raise ValueError(f"{name}: N = 0")
    if not isinstance(n_valid, torch.Tensor) and n_valid is not None and (
            not 0 <= int(n_valid) <= n):
        raise ValueError(f"{name}: n_valid {n_valid} outside [0, {n}]")
    return n


def _launch_carry_form(name: str, entry: str, px4: torch.Tensor, outs,
                       n_valid, prev_in, run_in, table_in, contains_last):
    """Launch the words or planes kernel (C entry `entry`) on a CUDA px4
    with the carry in; `outs` are its output tensors in the entry's order
    (between carry_in and carry_out, lens last). Returns the carry out."""
    _build.check_cuda(name, px4, dtype=torch.uint8)
    if px4.data_ptr() % 4:
        raise ValueError(f"{name}: px4 must be 4-byte aligned")
    n, dev = px4.shape[0], px4.device
    header, from_dev, cin = _carry_args(n, n_valid, prev_in, run_in,
                                        table_in, contains_last, dev)
    cout = torch.empty(2 + 64, dtype=torch.int64, device=dev)
    wr = torch.empty(64, dtype=torch.uint8, device=dev)
    scratch = torch.empty(1 + _COLS * -(-n // _TILE), dtype=torch.int64,
                          device=dev)
    with torch.cuda.device(dev):
        rc = getattr(_build.lib(), entry)(
            px4.data_ptr(), n, *header, from_dev,
            None if cin is None else cin.data_ptr(),
            *(t.data_ptr() for t in outs), cout.data_ptr(), wr.data_ptr(),
            scratch.data_ptr(), _build.stream_ptr(dev))
    _build.launched(name, rc)
    return _carry_out(cout, wr)


def encode_stage_words(px4: torch.Tensor, n_valid=None, prev_in=None,
                       run_in=None, table_in=None,
                       contains_last=None) -> pipeline.EncodedWords:
    """Word-form staging with the tile carries: px4 (N, 4) uint8, any
    N >= 1 -> EncodedWords with lo, hi and lens (N,) int32 (u32 bit
    patterns) and the outgoing EncoderCarry (prev_px (4,) uint8, run
    0-d int64, table (64,) int64 u32, written (64,) bool). The arguments
    are `encode_stage_chunks`'; n_valid, prev_in, run_in, table_in and
    contains_last may be Python values or tensors on the card, and are
    read there. CPU tensors take the plain twin; CUDA tensors launch the
    kernel (or raise)."""
    n = _check_carry_form("encode_stage_words", px4, n_valid)
    if px4.device.type == "cpu":
        return encode_stage_words_plain(px4, n_valid, prev_in, run_in,
                                        table_in, contains_last)
    lo, hi, lens = (torch.empty(n, dtype=torch.int32, device=px4.device)
                    for _ in range(3))
    carry = _launch_carry_form(
        "encode_stage_words", "qoi_encode_stage_words", px4, (lo, hi, lens),
        n_valid, prev_in, run_in, table_in, contains_last)
    return pipeline.EncodedWords(lo, hi, lens, carry)


def encode_stage_planes(px4: torch.Tensor, n_valid=None, prev_in=None,
                        run_in=None, table_in=None,
                        contains_last=None) -> pipeline.EncodedChunks:
    """Byte-plane staging with the tile carries: px4 (N, 4) uint8, any
    N >= 1 -> EncodedChunks with staging (6, N) uint8 (JAX's planes: an
    eq position keeps its run byte in plane 0), lens (N,) int32 and the
    outgoing EncoderCarry, as `encode_stage_words` takes and returns
    them. CPU tensors take the plain twin; CUDA tensors launch the
    kernel (or raise)."""
    n = _check_carry_form("encode_stage_planes", px4, n_valid)
    if px4.device.type == "cpu":
        return encode_stage_planes_plain(px4, n_valid, prev_in, run_in,
                                         table_in, contains_last)
    staging = torch.empty((6, n), dtype=torch.uint8, device=px4.device)
    lens = torch.empty(n, dtype=torch.int32, device=px4.device)
    carry = _launch_carry_form(
        "encode_stage_planes", "qoi_encode_stage_planes", px4,
        (staging, lens), n_valid, prev_in, run_in, table_in, contains_last)
    return pipeline.EncodedChunks(staging, lens, carry)


def _carry_out(cout: torch.Tensor, wr: torch.Tensor) -> pipeline.EncoderCarry:
    """The kernel's carry out -- cout (66,) int64: prev_px packed, run,
    table[64]; wr (64,) uint8: written[64] (csrc/encode_stage.cu, kOut*)
    -- as an EncoderCarry of the plain code's dtypes, views of the two."""
    return pipeline.EncoderCarry(cout[:1].view(torch.uint8)[:4], cout[1],
                                 cout[2:], wr.view(torch.bool))
