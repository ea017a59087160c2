"""Fused encode staging: CUDA kernel `csrc/encode_stage.cu` and its plain
twin (port of qoi_tpu/kernels/encode_stage.py::encode_stage_pallas).

Encoder stages 1-4 in one pass: px4 (N, 4) uint8 -> (staging (N, 6) uint8,
lens (N, 1) int32), with staged bytes at or past each length zeroed. The
JAX kernel walks 1024-pixel blocks in order, carrying the previous pixel,
the run phase and the colour table; the CUDA kernel computes those
carries instead, in one launch, by decoupled look-back (see its header).
`last_pos` is the global index of the stream's final pixel (default
n_valid - 1) or -1. As in the JAX kernel the pending run is cut to 0 at
every block start after the block that holds last_pos -- past the
stream's end for the default, so only a last_pos below n_valid - 1 shows
the 1024-pixel block in the result.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..models import pipeline
from . import _build

#: pixels per block, the JAX kernel's default block
_BLOCK = 1024
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
    # the ticket, then 65 look-back status words a block; 0 = unpublished
    scratch = torch.zeros(1 + _COLS * (n // _BLOCK), dtype=torch.int64,
                          device=dev)
    with torch.cuda.device(dev):
        rc = _build.lib().qoi_encode_stage(
            px4.data_ptr(), stag.data_ptr(), lens.data_ptr(),
            scratch.data_ptr(), n, min(n_valid, n), last_pos,
            _build.stream_ptr(dev))
    _build.launched("encode_stage", rc)
    return stag, lens
