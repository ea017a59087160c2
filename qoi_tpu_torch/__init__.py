"""qoi_tpu_torch -- the QOI codec engine of qoi_tpu, ported to PyTorch
with hand-written CUDA kernels for NVIDIA Hopper (sm_90a).

The layout mirrors qoi_tpu/ so each function's counterpart is found by
name: format, config, oracle and utils/testimages (the numpy leaves),
ops/ (scans, table, compact, fsm), models/ (pipeline, decode_v3,
streamed, scan_codec, buckets), kernels/ (slide, expand, block_maps,
pack, encode_stage, scan_codec: the Python wrappers and their plain
PyTorch twins) and csrc/ (the CUDA sources, built with nvcc at first use
into build/).

Every public function takes its tensors on an explicit device. The facade
below takes `device=`, defaults to "cuda" and raises when there is no
card; `device="cpu"` runs the plain PyTorch twins of the kernels. Images
up to STREAM_THRESHOLD_PX pixels go through the all-at-once paths
(models/pipeline, models/decode_v3), larger ones, up to the format's
400 Mpx cap, tile by tile through models/streamed. The package imports
neither JAX nor any module of qoi_tpu: it keeps its own copies of the
numpy leaves (format, config, oracle -- which binds the repo's cpp/
library -- and utils.testimages).
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from .format import StreamDesc, unpack_header

__version__ = "0.1.0"

#: pixel count above which the all-at-once paths' intermediates would
#: strain device memory; larger images stream tile by tile
STREAM_THRESHOLD_PX = 1 << 24


def _device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but torch sees no CUDA device; "
            "pass device='cpu' to run the plain PyTorch path")
    return dev


#: EngineConfig fields whose paths are not ported yet: the oracle and scan
#: engines and the per-call oracle check (io), the JAX table's block width
#: (the port's table is sort-based) and the device mesh (parallel)
_UNPORTED = ("engine", "verify", "table_block", "mesh")


def _check_config(config) -> None:
    """Validate `config`; refuse a field of _UNPORTED away from its
    default, rather than run the parallel path without it."""
    if config is None:
        return
    from .config import DEFAULT

    config.validate()
    unported = [f for f in _UNPORTED
                if getattr(config, f) != getattr(DEFAULT, f)]
    if unported:
        raise NotImplementedError(
            f"EngineConfig {', '.join(unported)}: not ported yet; only "
            "the defaults are taken")


def encode(pixels: np.ndarray, desc: Optional[StreamDesc] = None,
           device="cuda", config=None) -> bytes:
    """Encode pixels ((h, w, 3|4) uint8, or flat with an explicit desc) to
    a QOI stream, byte-identical to the reference encoder (qoi.h:356).
    `config` is an EngineConfig (qoi_tpu_torch.config)."""
    from .models import pipeline, streamed

    dev = _device(device)
    _check_config(config)
    if desc is None:
        h, w, ch = pixels.shape
        desc = StreamDesc(w, h, ch)
    if desc.num_pixels > STREAM_THRESHOLD_PX:
        return streamed.encode(pixels, desc, dev, config=config)
    return pipeline.encode(pixels, desc, dev, config=config)


def decode(data: bytes, channels: int = 0, device="cuda", config=None
           ) -> Tuple[np.ndarray, StreamDesc]:
    """Decode a QOI stream to ((h, w, ch) uint8, StreamDesc),
    pixel-identical to the reference decoder (qoi.h:488). channels=0 keeps
    the header's count; 3/4 force the output layout. `config` is an
    EngineConfig (qoi_tpu_torch.config)."""
    from .models import decode_v3, streamed

    dev = _device(device)
    _check_config(config)
    if unpack_header(data).num_pixels > STREAM_THRESHOLD_PX:
        return streamed.decode(data, channels, dev, config=config)
    return decode_v3.decode(data, channels, dev, config=config)
