"""Build, load and count the hand-written CUDA kernels.

Every `csrc/*.cu` file compiles with its own `nvcc`, all started
together, and the objects link into ONE shared library with a plain C
interface (no PyTorch headers, so a build takes seconds), keyed by a
hash of the sources and placed in `qoi_tpu_torch/build/`. It is loaded
with ctypes; every pointer and the stream pass as `c_void_p`.

Nothing here runs at import: the first kernel launch builds and loads
the library, so importing the package on a machine without `nvcc` or a
card never touches either.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
from typing import Dict, Optional

import torch

_PKG = pathlib.Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD = _PKG / "build"

#: target: Hopper with its architecture-specific features (sm_90a)
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_SIGNATURES = {
    # name: argtypes (pointers and the stream as c_void_p)
    "qoi_slide_val": [_P, _P, _P, ctypes.c_longlong, ctypes.c_int,
                      ctypes.c_int, ctypes.c_int, ctypes.c_int, _P],
    "qoi_expand_px": [_P, _P, _P, ctypes.c_longlong, ctypes.c_longlong,
                      ctypes.c_uint, _P],
    "qoi_block_maps": [_P, _P, _P, _P, _P, _P, _P, ctypes.c_int,
                       ctypes.c_int, _P],
    "qoi_slide_val2": [_P, _P, _P, _P, _P, ctypes.c_longlong, ctypes.c_int,
                       _P],
    "qoi_place_words": [_P, _P, _P, _P, ctypes.c_longlong,
                        ctypes.c_longlong, _P],
    "qoi_encode_stage": [_P, _P, _P, _P, ctypes.c_int, ctypes.c_int,
                         ctypes.c_int, _P],
    "qoi_encode_stage_words": [_P, *[ctypes.c_int] * 6, ctypes.c_uint,
                               *[_P] * 8],
    "qoi_encode_stage_planes": [_P, *[ctypes.c_int] * 6, ctypes.c_uint,
                                *[_P] * 7],
    "qoi_decode_scan": [_P, ctypes.c_longlong, ctypes.c_longlong,
                        ctypes.c_longlong, _P, _P, _P, _P],
    "qoi_encode_scan": [_P, ctypes.c_longlong, _P, _P, _P],
    "qoi_numeric_scan": [_P, _P, _P, _P, _P, _P, ctypes.c_int, ctypes.c_int,
                         _P],
    "qoi_fsm_scan": [_P, _P, _P, ctypes.c_longlong, _P],
    "qoi_fsm_starts": [_P, _P, _P, _P, ctypes.c_longlong, ctypes.c_longlong,
                       _P],
    "qoi_initial_scan": [_P, _P, _P, _P, _P, ctypes.c_longlong, _P],
    "qoi_initial_w": [_P, _P, _P, _P, _P, _P, ctypes.c_longlong, _P],
    "qoi_anch_scan": [_P, _P, _P, ctypes.c_longlong, ctypes.c_longlong, _P],
    "qoi_resolve_scan": [_P, _P, _P, _P, ctypes.c_longlong, _P],
    "qoi_compact_words": [_P, _P, _P, ctypes.c_longlong, _P,
                          ctypes.c_longlong, _P, _P, _P],
}

#: launches per kernel since the last `reset_launches()`; each wrapper
#: adds one where it launches its kernel, and nowhere else
launches: Dict[str, int] = {"slide_val": 0, "expand_px": 0,
                            "block_maps": 0, "slide_val2": 0,
                            "place_words": 0, "encode_stage": 0,
                            "encode_stage_words": 0,
                            "encode_stage_planes": 0,
                            "encode_scan": 0, "decode_scan": 0,
                            "numeric_scan": 0, "fsm_scan": 0,
                            "fsm_starts": 0, "initial_scan": 0,
                            "initial_w_scan": 0, "anch_scan": 0,
                            "resolve_scan": 0, "compact_words": 0}

_lib: Optional[ctypes.CDLL] = None


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    path = pathlib.Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError(
            "nvcc not found (PATH, CUDA_HOME or /usr/local/cuda/bin): the "
            "CUDA kernels cannot be built")
    return str(path)


def build() -> pathlib.Path:
    """Compile csrc/*.cu into build/libqoi_kernels_<hash>.so unless that
    file exists already; returns its path. One nvcc per source runs in
    parallel, then one links. The nvcc logs (ptxas register and
    shared-memory lines) go beside the library as a .log file."""
    srcs = sorted(CSRC.glob("*.cu"))
    h = hashlib.sha256()
    for s in srcs + sorted(CSRC.glob("*.cuh")):
        h.update(s.name.encode())
        h.update(s.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    out = BUILD / f"libqoi_kernels_{h.hexdigest()[:16]}.so"
    if out.exists():
        return out
    BUILD.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    tag = f"{out.stem}.{os.getpid()}"
    objs = [BUILD / f"{tag}.{src.stem}.o" for src in srcs]
    procs = [subprocess.Popen(
        [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for src, obj in zip(srcs, objs)]
    logs = [p.communicate()[0] for p in procs]
    failed = [(src.name, p.returncode, log)
              for src, p, log in zip(srcs, procs, logs) if p.returncode]
    tmp = BUILD / f"{tag}.so.tmp"
    if not failed:
        res = subprocess.run(
            [nvcc, *NVCC_FLAGS[:2], "-shared", "-o", str(tmp),
             *map(str, objs)], capture_output=True, text=True)
        logs.append(res.stdout + res.stderr)
        if res.returncode:
            failed.append(("link", res.returncode, logs[-1]))
    for obj in objs:
        obj.unlink(missing_ok=True)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(
            f"{name} ({rc}):\n{log}" for name, rc, log in failed))
    out.with_suffix(".log").write_text("".join(logs))
    os.replace(tmp, out)  # atomic: a concurrent build never sees half a file
    return out


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built at first use)."""
    global _lib
    if _lib is None:
        so = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(so, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = so
    return _lib


def check_cuda(name: str, *tensors: torch.Tensor,
               dtype: torch.dtype = torch.int32) -> None:
    """Raise unless every tensor is a contiguous `dtype` tensor on the
    same CUDA device (the kernels take u32 values as int32 bit
    patterns)."""
    dev = tensors[0].device
    for t in tensors:
        if t.device.type != "cuda":
            raise ValueError(
                f"{name}: tensor on {t.device}, kernel needs CUDA")
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {dev} and {t.device}")
        if t.dtype != dtype:
            raise TypeError(f"{name}: dtype {t.dtype}, kernel takes {dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: kernel needs contiguous tensors")


def stream_ptr(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def launched(name: str, rc: int) -> None:
    """Raise on a refused launch (the C entry returns cudaGetLastError()),
    else count it."""
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed, CUDA error {rc}")
    launches[name] += 1
