"""Tracing, timing and speed-of-light accounting (port of
qoi_tpu/utils/profiling.py).

- `trace(logdir)` profiles a region with torch.profiler (the host and,
  on the card, its kernels) and writes a Chrome/Perfetto trace,
  `logdir/trace.json`;
- `annotate(name)` names a region for the profiler: a record_function
  range while a profiler runs, nothing otherwise (the port's spans,
  `qoi.encode*` and `qoi.decode*`, stay on the hot path);
- `device_sync_time(fn)` times a device callable, synchronizing the card
  around every run (`device_sync_times` keeps every run's seconds);
- `encode_sol_model` / `decode_sol_model`: the JAX package's
  bytes-moved speed-of-light models, kept equal to them (the port's
  roofline share is the benchmark's `roofline_pct.*`);
- `scaling_efficiency`: N-shard Mpx/s over N times the 1-shard Mpx/s.

The JAX package's persistent compile cache (`enable_compile_cache`) has
no counterpart: the port's kernels are built once by nvcc
(kernels/_build.py).
"""
from __future__ import annotations

import contextlib
import pathlib
import time
from typing import Callable, Dict, List

import torch
from torch._C._autograd import _profiler_enabled


@contextlib.contextmanager
def trace(logdir, device="cuda"):
    """Profile a region on `device` and write `logdir/trace.json` (Chrome
    trace format, opens in Perfetto). On "cuda" the trace has the card's
    kernels beside the host's calls; it raises without a card. Yields the
    torch.profiler.profile object."""
    from torch.profiler import ProfilerActivity, profile

    from .. import _device

    acts = [ProfilerActivity.CPU]
    if _device(device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    out = pathlib.Path(logdir)
    out.mkdir(parents=True, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(str(out / "trace.json"))


class _Off:
    """The span of `annotate` with no profiler running: does nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


def annotate(name: str):
    """Named region, for `with`: a torch.profiler record_function range
    while a profiler is on (torch.profiler.profile, or emit_nvtx, which
    turns record_function ranges into NVTX ranges for Nsight Systems),
    and a shared do-nothing span otherwise, so that off a span costs one
    C call and one branch."""
    if _profiler_enabled():
        return torch.profiler.record_function(name)
    return _OFF


def device_sync_times(fn: Callable, reps: int = 5,
                      device="cuda") -> List[float]:
    """Seconds of each of `reps` runs of fn() after one warm-up call, on
    the host clock between two synchronizations of `device`
    (torch.cuda.synchronize on the card, so each time covers the work fn
    enqueued)."""
    from .. import _device

    dev = _device(device)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    fn()
    sync()
    out = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        sync()
        out.append(time.perf_counter() - t0)
    return out


def device_sync_time(fn: Callable, reps: int = 5, device="cuda") -> float:
    """Best-of-reps seconds of fn() (see `device_sync_times`)."""
    return min(device_sync_times(fn, reps, device))


# -- speed-of-light models (bytes moved at minimum, HBM-bandwidth bound) ----

#: HBM bandwidth of one H100 SXM, bytes/s (NVIDIA's data sheet, at the
#: full 700 W power limit): the rate PERF.md's bounds use
HBM_BYTES_PER_S = 3.35e12


def encode_sol_model(n_px: int, channels: int, rate: float = 0.45,
                     bw: float = HBM_BYTES_PER_S) -> Dict[str, float]:
    """Minimum-traffic model for encode: read pixels once (4 B/px after
    RGBA forcing), write staging once and read it back for compaction
    (~6 B/px worst, rate-dependent typical), write the stream (~rate *
    channels B/px)."""
    read_px = 4 * n_px
    staging = 2 * 6 * n_px  # write + read
    out = rate * channels * n_px
    total = read_px + staging + out
    return {
        "bytes_moved": total,
        "sol_seconds": total / bw,
        "sol_mpps": (n_px / 1e6) / (total / bw),
    }


def decode_sol_model(n_px: int, channels: int, rate: float = 0.45,
                     bw: float = HBM_BYTES_PER_S) -> Dict[str, float]:
    """Minimum-traffic model for decode: read the stream, tokenize (touch
    bytes ~2x), resolve + write pixels (4 B/px)."""
    stream = rate * channels * n_px
    total = 3 * stream + 4 * n_px
    return {
        "bytes_moved": total,
        "sol_seconds": total / bw,
        "sol_mpps": (n_px / 1e6) / (total / bw),
    }


def scaling_efficiency(mpps_by_shards):
    """Scaling efficiency[s] = Mpx/s at s shards divided by (s x Mpx/s at
    1 shard). mpps_by_shards: {shard_count: mpps}. Returns {shard_count:
    efficiency in [0, ~1]}; requires the 1-shard entry."""
    base = mpps_by_shards[1]
    if base <= 0:
        raise ValueError("1-shard throughput must be positive")
    return {s: v / (s * base) for s, v in sorted(mpps_by_shards.items())}
