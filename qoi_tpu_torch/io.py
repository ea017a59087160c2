"""File I/O (reference L2: qoi.h:592-648), PNG bridging and engine
resolution: the port's counterpart of qoi_tpu/io.py.

`write`/`read` mirror `qoi_write`/`qoi_read` (reference qoi.h:595-646):
whole-file encode/decode with the engine of choice on `device` (default
"cuda"; raises without a card, pass "cpu" for the plain path). PNG
load/save goes through PIL, imported only inside `load_png`/`save_png`,
normalizing to 8-bit RGB/RGBA exactly like the reference's loaders force
non-3-channel sources to 4 (qoiconv.c:51-56).
"""
from __future__ import annotations

import dataclasses
import pathlib
from typing import Callable, Optional, Tuple, Union

import numpy as np

from . import config as cfg
from . import format as fmt


def _as_config(engine: Union[str, "cfg.EngineConfig"],
               config: Optional["cfg.EngineConfig"] = None
               ) -> "cfg.EngineConfig":
    """The validated EngineConfig of an engine name or EngineConfig, and of
    the facade's `config=`. With both a name and a config, the config's
    fields hold and a name other than the default "tpu" sets its engine
    (a config naming another engine is refused); an EngineConfig passed
    as both `engine` and `config` is refused."""
    if isinstance(engine, cfg.EngineConfig):
        if config is not None:
            raise ValueError("pass the EngineConfig as engine= or as "
                             "config=, not both")
        c = engine
    elif config is None:
        c = cfg.EngineConfig(engine=engine)
    elif engine == cfg.DEFAULT.engine or engine == config.engine:
        c = config
    elif config.engine == cfg.DEFAULT.engine:
        c = dataclasses.replace(config, engine=engine)
    else:
        raise ValueError(f"engine {engine!r} and config.engine "
                         f"{config.engine!r} disagree")
    c.validate()
    return c


def _engine(engine: Union[str, "cfg.EngineConfig"], device
            ) -> Tuple[Callable, Callable]:
    """Resolve (encode(pixels, desc), decode(data, channels=0)) callables
    on `device` for an engine name or a full EngineConfig.

    "tpu" is the parallel device path (the name is kept so that an
    EngineConfig means the same in both packages): models/pipeline and
    models/decode_v3, and models/streamed above
    qoi_tpu_torch.STREAM_THRESHOLD_PX pixels; with `config.mesh` =
    (data, seq) the sequence-parallel codec (parallel/tiled,
    parallel/tiled_decode) over a mesh of the initialized process group,
    which must have data*seq ranks, each of which calls it. "scan" is
    the sequential codec (models/scan_codec, whose two walks are CUDA
    kernels on the card), "oracle" the C++ host codec.
    `config.table_block` has no effect: it is the width of the JAX
    package's brute-force table, and the port's table (ops/table.py) is
    sort-based, with the same output for every width."""
    import torch

    c = _as_config(engine)
    dev = torch.device(device)
    if c.engine == "tpu" and c.mesh is not None:
        from .parallel import sharding, tiled, tiled_decode

        mesh = sharding.make_mesh(*c.mesh, device=dev)
        return (lambda px, desc: tiled.encode_tiled(px, desc, mesh, dev),
                lambda data, ch=0: tiled_decode.decode_tiled(
                    data, mesh, ch, dev))
    if c.engine == "tpu":
        from . import _decode_tpu, _encode_tpu

        return (lambda px, desc: _encode_tpu(px, desc, dev, c),
                lambda data, ch=0: _decode_tpu(data, ch, dev, c))
    if c.engine == "scan":
        from .models import scan_codec

        return (lambda px, desc: scan_codec.encode(px, desc, dev),
                lambda data, ch=0: scan_codec.decode(data, ch, dev))
    from . import oracle

    return oracle.encode, oracle.decode


def write(path, pixels: np.ndarray, desc: fmt.StreamDesc,
          engine: Union[str, "cfg.EngineConfig"] = "tpu",
          device="cuda") -> int:
    """Encode and write a .qoi file; returns bytes written (reference
    qoi_write, qoi.h:595). `engine` is a name or an EngineConfig; with
    config.verify the stream is differentially checked vs the oracle."""
    from . import _device

    dev = _device(device)
    c = _as_config(engine)
    enc, _ = _engine(c, dev)
    data = enc(pixels, desc)
    if c.verify and c.engine != "oracle":
        from . import oracle

        if oracle.available() and data != oracle.encode(pixels, desc):
            raise AssertionError("encode mismatch vs the C++ oracle")
    pathlib.Path(path).write_bytes(data)
    return len(data)


def read(path, channels: int = 0,
         engine: Union[str, "cfg.EngineConfig"] = "tpu", device="cuda"
         ) -> Tuple[np.ndarray, fmt.StreamDesc]:
    """Read and decode a .qoi file (reference qoi_read, qoi.h:619).
    channels=0 uses the header count. `engine` and `device` as in
    `write`."""
    from . import _device

    dev = _device(device)
    c = _as_config(engine)
    _, dec = _engine(c, dev)
    data = pathlib.Path(path).read_bytes()
    img, desc = dec(data, channels)
    if c.verify and c.engine != "oracle":
        from . import oracle

        if oracle.available():
            want, _ = oracle.decode(data, channels)
            if not np.array_equal(img, want):
                raise AssertionError("decode mismatch vs the C++ oracle")
    return img, desc


def load_png(path) -> np.ndarray:
    """Load a PNG as (h, w, 3|4) uint8; non-RGB modes are normalized the
    way the reference's stbi loader forces channels (qoiconv.c:51-56)."""
    from PIL import Image

    with Image.open(path) as im:
        if im.mode == "RGB":
            return np.asarray(im, dtype=np.uint8)
        if im.mode != "RGBA":
            im = im.convert("RGBA")
        return np.asarray(im, dtype=np.uint8)


def save_png(path, pixels: np.ndarray) -> None:
    """Save (h, w, 3|4) uint8 pixels as PNG."""
    from PIL import Image

    arr = np.ascontiguousarray(pixels, dtype=np.uint8)
    mode = "RGB" if arr.shape[-1] == 3 else "RGBA"
    Image.fromarray(arr, mode).save(path, format="PNG")


def image_desc(pixels: np.ndarray, colorspace: int = fmt.SRGB
               ) -> fmt.StreamDesc:
    h, w, ch = pixels.shape
    return fmt.StreamDesc(w, h, ch, colorspace)
