"""Event slides: CUDA kernels `csrc/slide.cu` and their plain twins.

Counterparts of qoi_tpu/kernels/slide.py::slide_val and slide_val2. val
(and val2): (nseg, sw) int32 (u32 bit patterns); aux: (nseg, sw) int32
with the alive flag in bit 0 and the slide distance in bits 1.., as
`ops/compact._wordsum_events_words` (one plane) and
`models/decode_v3._chunk_events` (two planes) build them. Every alive
event's destination i - dist is unique inside its row. The slides return
the slid planes, 0 wherever no event landed.

On the card the one-plane slide holds each row in one thread-block
cluster's shared memory (see `csrc/slide.cu`), so a row may be at most
`MAX_SW` words wide; `cluster_shape` picks the cluster.
"""
from __future__ import annotations

import torch

from . import _build

#: blocks of one cluster at most (the portable cluster size), the words of
#: one block's slice at most (48 KB of shared memory) and the slice width
#: below which the cluster stops growing
MAX_CLUSTER = 8
MAX_SLICE = 12288
_TARGET_SLICE = 4096
#: the widest row the one-plane kernel takes (the callers pass at most
#: 2 * 20480, `ops/compact`'s segment)
MAX_SW = MAX_CLUSTER * MAX_SLICE


def cluster_shape(sw: int):
    """(k, slice) of the one-plane kernel for rows of sw words: k blocks
    (a power of two, at most MAX_CLUSTER, the least whose slices are at
    most _TARGET_SLICE words) of `slice` words each (ceil(sw / k), made a
    multiple of 4 when sw is one, so that 16-byte loads and stores stay
    aligned). The last slice may be shorter. Raises ValueError past
    MAX_SW."""
    if sw > MAX_SW:
        raise ValueError(
            f"slide_val: rows of {sw} words exceed the kernel's limit of "
            f"{MAX_SW} ({MAX_CLUSTER} blocks of a cluster x {MAX_SLICE} "
            "words of shared memory); use a narrower segment")
    k = 1
    while k < MAX_CLUSTER and -(-sw // k) > _TARGET_SLICE:
        k *= 2
    width = -(-sw // k)
    if sw % 4 == 0:
        width = -(-width // 4) * 4
    return k, width


def _slide_plain(vals, aux: torch.Tensor):
    """The radix-2 shift slide of qoi_tpu/ops/compact._wordsum_slide and
    kernels/slide._slide_kernel2 over any number of value planes riding
    the same moves: log2(sw) passes, each moving the events whose
    distance has that bit set, then the alive mask."""
    nseg, sw = aux.shape

    def shift_rows(x, j):
        return torch.cat([x[:, j:], x.new_zeros((nseg, j))], dim=1)

    bit = 1
    while bit < sw:
        aux_s = shift_rows(aux, bit)
        dbit = bit << 1
        mv_in = ((aux_s & dbit) != 0) & ((aux_s & 1) != 0)
        mv_out = ((aux & dbit) != 0) & ((aux & 1) != 0)
        vals = [torch.where(mv_in, shift_rows(v, bit), v) for v in vals]
        aux = torch.where(mv_in, aux_s, torch.where(mv_out, 0, aux))
        bit <<= 1
    alive = (aux & 1) != 0
    return [torch.where(alive, v, 0) for v in vals]


def slide_val_plain(val: torch.Tensor, aux: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch twin of the one-plane slide."""
    return _slide_plain([val], aux)[0]


def slide_val2_plain(val: torch.Tensor, val2: torch.Tensor,
                     aux: torch.Tensor):
    """Plain PyTorch twin of the two-plane slide; returns (val', val2')."""
    return tuple(_slide_plain([val, val2], aux))


def slide_val(val: torch.Tensor, aux: torch.Tensor) -> torch.Tensor:
    """Slide events to their within-row positions. CPU tensors take the
    plain twin; CUDA tensors launch the kernel (or raise; rows wider than
    MAX_SW raise ValueError)."""
    if val.shape != aux.shape or val.dim() != 2:
        raise ValueError(f"slide_val: shapes {tuple(val.shape)} and "
                         f"{tuple(aux.shape)}, want two equal (nseg, sw)")
    if val.device.type == "cpu" and aux.device.type == "cpu":
        return slide_val_plain(val, aux)
    _build.check_cuda("slide_val", val, aux)
    nseg, sw = val.shape
    k, width = cluster_shape(sw)
    out = torch.empty_like(val)  # the kernel writes every word
    if val.numel() == 0:
        return out
    vec = sw % 4 == 0 and all(t.data_ptr() % 16 == 0 for t in (val, aux,
                                                                out))
    with torch.cuda.device(val.device):
        rc = _build.lib().qoi_slide_val(
            val.data_ptr(), aux.data_ptr(), out.data_ptr(), nseg, sw, k,
            width, int(vec), _build.stream_ptr(val.device))
    _build.launched("slide_val", rc)
    return out


def slide_val2(val: torch.Tensor, val2: torch.Tensor, aux: torch.Tensor):
    """Slide two value planes through the same moves; returns (val',
    val2'). CPU tensors take the plain twin; CUDA tensors launch the
    kernel (or raise)."""
    if not (val.shape == val2.shape == aux.shape) or val.dim() != 2:
        raise ValueError(f"slide_val2: shapes {tuple(val.shape)}, "
                         f"{tuple(val2.shape)} and {tuple(aux.shape)}, "
                         "want three equal (nseg, sw)")
    if all(t.device.type == "cpu" for t in (val, val2, aux)):
        return slide_val2_plain(val, val2, aux)
    _build.check_cuda("slide_val2", val, val2, aux)
    out = torch.zeros_like(val)
    out2 = torch.zeros_like(val2)
    if val.numel() == 0:
        return out, out2
    with torch.cuda.device(val.device):
        rc = _build.lib().qoi_slide_val2(
            val.data_ptr(), val2.data_ptr(), aux.data_ptr(), out.data_ptr(),
            out2.data_ptr(), val.numel(), val.shape[1],
            _build.stream_ptr(val.device))
    _build.launched("slide_val2", rc)
    return out, out2
