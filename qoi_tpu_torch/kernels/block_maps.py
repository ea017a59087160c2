"""Decode pass 1, per-block symbolic maps: CUDA kernel `csrc/block_maps.cu`
and its plain twin.

Counterpart of the `lax.scan` in qoi_tpu/models/decode_v3.py::_block_maps
with emit_px=True. Inputs are position-major (b, nb) int32 planes: meta =
cls | w << 3 | r6 << 9, d32 and lit32 (u32 bit patterns). Each of the nb
block lanes walks its b positions carrying the 65-entry decoder state
symbolically, per channel (root, val) packed in u32 bytes: root 0 = the
block's entry px, 1+s = entry slot s, 65 = absolute.

Returns (root (65, nb), val (65, nb), proot (b, nb), pval (b, nb)), all
int32 bit patterns: the whole map after the block, and the px entry after
every position.

The kernel cuts each lane into segments walked at the same time and
composes their maps in the same launch (csrc/block_maps.cu); the twin
walks each lane in one piece.
"""
from __future__ import annotations

import torch

from .._bits import swar_add, to_i32, u32
from . import _build

#: op classes of the cls field (decode_v3._fields builds them; the kernel
#: source hard-codes the same values): 0 identity (non-chunk byte),
#: 1 additive (RUN d=0 / DIFF / LUMA), 2 RGB, 3 RGBA, 4 INDEX
_CLS_ID, _CLS_ADD, _CLS_RGB, _CLS_RGBA, _CLS_INDEX = range(5)


def _step_val(cls, d32, lit32, px_val, src_val):
    """New numeric px for one step (the value half of
    decode_v3._step_common): ADD adds d32 bytewise, RGB takes the
    literal's rgb under the running alpha, RGBA the literal, INDEX the
    slot's value; other classes keep px."""
    addv = swar_add(px_val, d32)
    rgbv = (lit32 & 0x00FFFFFF) | (px_val & 0xFF000000)
    return torch.where(cls == _CLS_ADD, addv,
           torch.where(cls == _CLS_RGB, rgbv,
           torch.where(cls == _CLS_RGBA, lit32,
           torch.where(cls == _CLS_INDEX, src_val, px_val))))


def _step_common(cls, d32, lit32, px_root, px_val, src_root, src_val):
    """New px entry (root, val) for one step (decode_v3._step_common)."""
    new_val = _step_val(cls, d32, lit32, px_val, src_val)
    rgbr = (px_root & 0xFF000000) | 0x00414141   # rgb absolute, a flows
    new_root = torch.where(cls == _CLS_ADD, px_root,
               torch.where(cls == _CLS_RGB, rgbr,
               torch.where(cls == _CLS_RGBA, 0x41414141,
               torch.where(cls == _CLS_INDEX, src_root, px_root))))
    return new_root, new_val


def block_maps_plain(meta: torch.Tensor, d32: torch.Tensor,
                     lit32: torch.Tensor):
    """Plain PyTorch twin: a Python loop over the b positions, each step
    vectorized over the nb lanes (the JAX scan body). An INDEX reads and
    writes the same slot w, so one gather serves both."""
    b, nb = meta.shape
    dev = meta.device
    meta = meta.to(torch.int64)
    d32, lit32 = u32(d32), u32(lit32)
    slots = torch.arange(64, dtype=torch.int64, device=dev)
    troot = ((1 + slots) * 0x01010101)[:, None].expand(64, nb).contiguous()
    tval = torch.zeros((64, nb), dtype=torch.int64, device=dev)
    px_root = torch.zeros(nb, dtype=torch.int64, device=dev)
    px_val = torch.zeros(nb, dtype=torch.int64, device=dev)
    proot = torch.empty((b, nb), dtype=torch.int64, device=dev)
    pval = torch.empty((b, nb), dtype=torch.int64, device=dev)
    for i in range(b):
        cls = meta[i] & 7
        w = ((meta[i] >> 3) & 63)[None]
        src_root = troot.gather(0, w)[0]
        src_val = tval.gather(0, w)[0]
        new_root, new_val = _step_common(cls, d32[i], lit32[i], px_root,
                                         px_val, src_root, src_val)
        live = cls != _CLS_ID
        px_root = torch.where(live, new_root, px_root)
        px_val = torch.where(live, new_val, px_val)
        troot.scatter_(0, w, torch.where(live, new_root, src_root)[None])
        tval.scatter_(0, w, torch.where(live, new_val, src_val)[None])
        proot[i] = px_root
        pval[i] = px_val
    root = torch.cat([px_root[None], troot])
    val = torch.cat([px_val[None], tval])
    return to_i32(root), to_i32(val), to_i32(proot), to_i32(pval)


def block_maps(meta: torch.Tensor, d32: torch.Tensor, lit32: torch.Tensor):
    """Pass 1. CPU tensors take the plain twin; CUDA tensors launch the
    kernel (or raise)."""
    if not (meta.shape == d32.shape == lit32.shape) or meta.dim() != 2:
        raise ValueError("block_maps: want three equal (b, nb) planes")
    if all(t.device.type == "cpu" for t in (meta, d32, lit32)):
        return block_maps_plain(meta, d32, lit32)
    _build.check_cuda("block_maps", meta, d32, lit32)
    b, nb = meta.shape
    dev = meta.device
    proot = torch.empty((b, nb), dtype=torch.int32, device=dev)
    pval = torch.empty((b, nb), dtype=torch.int32, device=dev)
    root = torch.empty((65, nb), dtype=torch.int32, device=dev)
    val = torch.empty((65, nb), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        rc = _build.lib().qoi_block_maps(
            meta.data_ptr(), d32.data_ptr(), lit32.data_ptr(),
            proot.data_ptr(), pval.data_ptr(), root.data_ptr(),
            val.data_ptr(), b, nb, _build.stream_ptr(dev))
    _build.launched("block_maps", rc)
    return root, val, proot, pval
