"""qoi_tpu_torch -- the QOI codec engine of qoi_tpu, ported to PyTorch
with hand-written CUDA kernels for NVIDIA Hopper (sm_90a).

The layout mirrors qoi_tpu/ so each function's counterpart is found by
name: format, config, oracle and utils/testimages (the numpy leaves),
the user surfaces (io, cli, corpus, bench, utils/profiling), ops/
(scans, table, link, compact, fsm), models/ (pipeline, decode_v3,
decode_pipeline, decode_v2, streamed, scan_codec, batch), kernels/
(slide, expand, block_maps, pack, encode_stage, compact_words,
scan_codec, numeric_scan: the Python wrappers and their plain PyTorch
twins) and csrc/ (the CUDA sources, built with nvcc at first use into
build/).

Every public function takes its tensors on an explicit device. The facade
below and every user surface take `device=`, default to "cuda" and raise
when there is no card; `device="cpu"` runs the plain PyTorch twins of the
kernels. `engine=` picks the codec as in qoi_tpu (io._engine). Images
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


def _encode_tpu(pixels, desc, dev, config) -> bytes:
    """The parallel encode on `dev`: all at once up to
    STREAM_THRESHOLD_PX pixels, tile by tile above."""
    from .models import pipeline, streamed

    if desc.num_pixels > STREAM_THRESHOLD_PX:
        return streamed.encode(pixels, desc, dev, config=config)
    return pipeline.encode(pixels, desc, dev, config=config)


def _decode_tpu(data, channels, dev, config):
    """The parallel decode on `dev`: all at once up to
    STREAM_THRESHOLD_PX pixels, tile by tile above."""
    from .models import decode_v3, streamed

    if unpack_header(data).num_pixels > STREAM_THRESHOLD_PX:
        return streamed.decode(data, channels, dev, config=config)
    return decode_v3.decode(data, channels, dev, config=config)


def encode(pixels: np.ndarray, desc: Optional[StreamDesc] = None,
           engine="tpu", device="cuda", config=None) -> bytes:
    """Encode pixels ((h, w, 3|4) uint8, or flat with an explicit desc) to
    a QOI stream, byte-identical to the reference encoder (qoi.h:356).
    `engine` is a name ("tpu", "scan", "oracle") or an EngineConfig
    (qoi_tpu_torch.config); `config` is an EngineConfig whose engine a
    name other than "tpu" overrides (io._as_config)."""
    from . import io as _io

    dev = _device(device)
    c = _io._as_config(engine, config)
    if desc is None:
        desc = _io.image_desc(pixels)
    enc, _ = _io._engine(c, dev)
    return enc(pixels, desc)


def decode(data: bytes, channels: int = 0, engine="tpu", device="cuda",
           config=None) -> Tuple[np.ndarray, StreamDesc]:
    """Decode a QOI stream to ((h, w, ch) uint8, StreamDesc),
    pixel-identical to the reference decoder (qoi.h:488). channels=0 keeps
    the header's count; 3/4 force the output layout. `engine` and
    `config` as in `encode`."""
    from . import io as _io

    dev = _device(device)
    c = _io._as_config(engine, config)
    _, dec = _io._engine(c, dev)
    return dec(data, channels)
