"""Word-sum event slide: CUDA kernel `csrc/slide.cu` and its plain twin.

Counterpart of qoi_tpu/kernels/slide.py::slide_val. val: (nseg, sw)
int32 (u32 bit patterns); aux: (nseg, sw) int32 with the alive flag in
bit 0 and the slide distance in bits 1.., both as
`ops/compact._wordsum_events_words` builds them. Returns the slid val
plane, 0 wherever no event landed.
"""
from __future__ import annotations

import torch

from . import _build


def slide_val_plain(val: torch.Tensor, aux: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch twin: the radix-2 shift slide of
    qoi_tpu/ops/compact._wordsum_slide -- log2(sw) passes, each moving the
    events whose distance has that bit set, then the alive mask."""
    nseg, sw = val.shape

    def shift_rows(x, j):
        return torch.cat([x[:, j:], x.new_zeros((nseg, j))], dim=1)

    bit = 1
    while bit < sw:
        val_s, aux_s = shift_rows(val, bit), shift_rows(aux, bit)
        dbit = bit << 1
        mv_in = ((aux_s & dbit) != 0) & ((aux_s & 1) != 0)
        mv_out = ((aux & dbit) != 0) & ((aux & 1) != 0)
        val = torch.where(mv_in, val_s, val)
        aux = torch.where(mv_in, aux_s, torch.where(mv_out, 0, aux))
        bit <<= 1
    return torch.where((aux & 1) != 0, val, 0)


def slide_val(val: torch.Tensor, aux: torch.Tensor) -> torch.Tensor:
    """Slide events to their within-row positions. CPU tensors take the
    plain twin; CUDA tensors launch the kernel (or raise)."""
    if val.shape != aux.shape or val.dim() != 2:
        raise ValueError(f"slide_val: shapes {tuple(val.shape)} and "
                         f"{tuple(aux.shape)}, want two equal (nseg, sw)")
    if val.device.type == "cpu" and aux.device.type == "cpu":
        return slide_val_plain(val, aux)
    _build.check_cuda("slide_val", val, aux)
    out = torch.zeros_like(val)
    if val.numel() == 0:
        return out
    with torch.cuda.device(val.device):
        rc = _build.lib().qoi_slide_val(
            val.data_ptr(), aux.data_ptr(), out.data_ptr(), val.numel(),
            val.shape[1], _build.stream_ptr(val.device))
    _build.launched("slide_val", rc)
    return out
