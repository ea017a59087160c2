"""Run expansion: CUDA kernel `csrc/expand.cu` and its plain twin.

Counterpart of qoi_tpu/kernels/expand.py. Every output pixel p takes the
px of its governing chunk (the last byte with pix_off <= p): pixels
before any chunk keep the seed, pixels past the last chunk repeat its px
(reference qoi.h:544). The twin, like the JAX package, gets it by the
telescoping identity: with d[i] = px32[i] - px32[i-1] (seed before byte
0) and landed[p] = sum of d[i] over bytes with pix_off[i] == p, the
plane is cumsum(landed) + seed mod 2^32. The kernel fills each byte's
pixel range directly.

pix_off: (M,) int32 nondecreasing; px32: (M,) int32 (u32 bit patterns).
Both functions return the (n_px_cap,) int32 pixel plane.
"""
from __future__ import annotations

import torch

from .. import format as fmt
from .._bits import M32, to_i32, u32
from . import _build

_SEED32 = (fmt.SEED_PIXEL[0] | fmt.SEED_PIXEL[1] << 8
           | fmt.SEED_PIXEL[2] << 16 | fmt.SEED_PIXEL[3] << 24)


def expand_px_xla(pix_off: torch.Tensor, px32: torch.Tensor,
                  n_px_cap: int) -> torch.Tensor:
    """Plain PyTorch twin of the JAX `expand_px_xla`: one scatter-add of
    the deltas (out-of-range offsets dropped) and a cumsum."""
    px = u32(px32)
    prev = torch.cat([px.new_full((1,), _SEED32), px[:-1]])
    d = (px - prev) & M32
    off = pix_off.to(torch.int64)
    keep = (off >= 0) & (off < n_px_cap)
    plane = px.new_zeros(n_px_cap).index_add_(0, off[keep], d[keep])
    return to_i32((torch.cumsum(plane, dim=0) + _SEED32) & M32)


def expand_px(pix_off: torch.Tensor, px32: torch.Tensor,
              n_px_cap: int) -> torch.Tensor:
    """Pixel plane from per-byte decode results. CPU tensors take the
    plain twin; CUDA tensors launch the kernel (or raise).

    Precondition: pix_off is nondecreasing and >= 0, as the decode makes
    it (offsets >= n_px_cap own no pixel). The kernel writes every output
    word exactly once under it; it is not checked here, since a check
    would sync with the card."""
    if pix_off.shape != px32.shape or pix_off.dim() != 1:
        raise ValueError(f"expand_px: shapes {tuple(pix_off.shape)} and "
                         f"{tuple(px32.shape)}, want two equal (M,)")
    if pix_off.device.type == "cpu" and px32.device.type == "cpu":
        return expand_px_xla(pix_off, px32, n_px_cap)
    _build.check_cuda("expand_px", pix_off, px32)
    out = torch.empty(n_px_cap, dtype=torch.int32, device=px32.device)
    with torch.cuda.device(px32.device):
        rc = _build.lib().qoi_expand_px(
            pix_off.data_ptr(), px32.data_ptr(), out.data_ptr(),
            px32.numel(), n_px_cap, _SEED32,
            _build.stream_ptr(px32.device))
    _build.launched("expand_px", rc)
    return out
