"""qoi_tpu_torch -- the QOI codec engine of qoi_tpu, ported to PyTorch
with hand-written CUDA kernels for NVIDIA Hopper (sm_90a).

The layout mirrors qoi_tpu/ so each function's counterpart is found by
name: format, oracle and utils/testimages (the numpy leaves), ops/
(scans, table, compact, fsm), models/ (pipeline, decode_v3, buckets),
kernels/ (slide, expand, block_maps, pack, encode_stage: the Python
wrappers and their plain PyTorch twins) and csrc/ (the CUDA sources,
built with nvcc at first use into build/).

Every public function takes its tensors on an explicit device. The facade
below takes `device=`, defaults to "cuda" and raises when there is no
card; `device="cpu"` runs the plain PyTorch twins of the kernels. The
package imports neither JAX nor any module of qoi_tpu: it keeps its own
copies of the numpy leaves (format, oracle -- which binds the repo's
cpp/ library -- and utils.testimages).
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from .format import StreamDesc, unpack_header

__version__ = "0.1.0"

#: pixel count above which qoi_tpu streams tile by tile; the streamed
#: path is not ported yet, so larger images raise here
STREAM_THRESHOLD_PX = 1 << 24


def _device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but torch sees no CUDA device; "
            "pass device='cpu' to run the plain PyTorch path")
    return dev


def _too_big(num_pixels: int) -> None:
    if num_pixels > STREAM_THRESHOLD_PX:
        raise NotImplementedError(
            f"{num_pixels} px is above STREAM_THRESHOLD_PX "
            f"({STREAM_THRESHOLD_PX}): the streamed path is not ported yet")


def encode(pixels: np.ndarray, desc: Optional[StreamDesc] = None,
           device="cuda") -> bytes:
    """Encode pixels ((h, w, 3|4) uint8, or flat with an explicit desc) to
    a QOI stream, byte-identical to the reference encoder (qoi.h:356)."""
    from .models import pipeline

    dev = _device(device)
    if desc is None:
        h, w, ch = pixels.shape
        desc = StreamDesc(w, h, ch)
    _too_big(desc.num_pixels)
    return pipeline.encode(pixels, desc, dev)


def decode(data: bytes, channels: int = 0, device="cuda"
           ) -> Tuple[np.ndarray, StreamDesc]:
    """Decode a QOI stream to ((h, w, ch) uint8, StreamDesc),
    pixel-identical to the reference decoder (qoi.h:488). channels=0 keeps
    the header's count; 3/4 force the output layout."""
    from .models import decode_v3

    dev = _device(device)
    _too_big(unpack_header(data).num_pixels)
    return decode_v3.decode(data, channels, dev)
