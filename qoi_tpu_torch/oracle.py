"""ctypes binding to the native C++ oracle codec (cpp/qoi_oracle.cpp).

The oracle is the framework's ground truth for differential testing
(SURVEY.md §2.4): encodes must match it byte-for-byte and decodes
pixel-for-pixel. It is also the single-core CPU fallback path. The shared
library is built on demand with the cpp/Makefile, under an exclusive lock
on `qoi_tpu_torch/build/oracle.lock`: processes that start together (test
workers) wait for one build and load the library only after `make` has
returned, never a half-written one.
"""
from __future__ import annotations

import ctypes
import fcntl
import pathlib
import subprocess
from typing import Optional, Tuple

import numpy as np

from .format import StreamDesc

_CPP_DIR = pathlib.Path(__file__).resolve().parent.parent / "cpp"
_LIB_PATH = _CPP_DIR / "build" / "libqoi_oracle.so"
_LOCK_PATH = pathlib.Path(__file__).resolve().parent / "build" / "oracle.lock"
_lib: Optional[ctypes.CDLL] = None


def _build_locked() -> None:
    """Run `make` for the library unless it exists, holding the lock file
    for the check and the build, so that one process builds and the
    others wait for it."""
    _LOCK_PATH.parent.mkdir(parents=True, exist_ok=True)
    with open(_LOCK_PATH, "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not _LIB_PATH.exists():
            subprocess.run(
                ["make", "-s", str(_LIB_PATH.relative_to(_CPP_DIR))],
                cwd=_CPP_DIR,
                check=True,
            )


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is not None:
        return _lib
    _build_locked()
    lib = ctypes.CDLL(str(_LIB_PATH))
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.qo_encode.restype = u8p
    lib.qo_encode.argtypes = [
        u8p, ctypes.c_uint32, ctypes.c_uint32, ctypes.c_uint8,
        ctypes.c_uint8, ctypes.POINTER(ctypes.c_size_t),
    ]
    lib.qo_decode.restype = u8p
    lib.qo_decode.argtypes = [
        u8p, ctypes.c_size_t, ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint32), ctypes.POINTER(ctypes.c_uint32),
        ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_uint8),
        ctypes.POINTER(ctypes.c_size_t),
    ]
    lib.qo_free.argtypes = [u8p]
    _lib = lib
    return lib


def available() -> bool:
    """True if the native library is present or can be built."""
    try:
        _load()
        return True
    except (OSError, subprocess.CalledProcessError):
        return False


def encode(pixels: np.ndarray, desc: StreamDesc) -> bytes:
    """Encode `pixels` (uint8, h*w*channels elements in any shape) to a QOI
    stream, byte-identical to the reference encoder (qoi.h:356)."""
    lib = _load()
    desc.validate()
    flat = np.ascontiguousarray(pixels, dtype=np.uint8).reshape(-1)
    expect = desc.num_pixels * desc.channels
    if flat.size != expect:
        raise ValueError(f"pixel buffer has {flat.size} bytes, expected {expect}")
    n = ctypes.c_size_t()
    ptr = lib.qo_encode(
        flat.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        desc.width, desc.height, desc.channels, desc.colorspace,
        ctypes.byref(n),
    )
    if not ptr:
        raise ValueError("oracle encode rejected the input")
    try:
        return bytes(ctypes.cast(ptr, ctypes.POINTER(ctypes.c_uint8 * n.value)).contents)
    finally:
        lib.qo_free(ptr)


def decode(data: bytes, channels: int = 0) -> Tuple[np.ndarray, StreamDesc]:
    """Decode a QOI stream. channels=0 uses the header count; 3/4 force the
    output layout (reference qoi.h:523-525). Returns (pixels[h,w,ch], desc
    with *header* values)."""
    lib = _load()
    buf = (ctypes.c_uint8 * len(data)).from_buffer_copy(data)
    w = ctypes.c_uint32()
    h = ctypes.c_uint32()
    ch = ctypes.c_uint8()
    cs = ctypes.c_uint8()
    n = ctypes.c_size_t()
    ptr = lib.qo_decode(
        buf, len(data), channels,
        ctypes.byref(w), ctypes.byref(h), ctypes.byref(ch), ctypes.byref(cs),
        ctypes.byref(n),
    )
    if not ptr:
        raise ValueError("oracle decode rejected the stream")
    try:
        raw = np.frombuffer(
            ctypes.cast(ptr, ctypes.POINTER(ctypes.c_uint8 * n.value)).contents,
            dtype=np.uint8,
        ).copy()
    finally:
        lib.qo_free(ptr)
    out_ch = channels if channels in (3, 4) else ch.value
    desc = StreamDesc(w.value, h.value, ch.value, cs.value)
    return raw.reshape(h.value, w.value, out_ch), desc
