"""Where the time of the slide_val and staging kernels goes, on the card.

Run from the repository root on a machine with a CUDA card:

    python3 -m qoi_tpu_torch.kernel_profile

It builds the kernels, prints the ptxas lines of the build (registers,
spills), then, at the 4K shapes `chip_smoke.py` uses (the slide planes of a
3840x2160 mixed RGBA frame's word-sum events, and the staging of that
frame and of a 4K RGB photo frame in its three forms: fused, words and
planes), times each wrapper call with CUDA events (mean of 20 calls after
one warm-up), the slide wrapper's output allocation alone, and lists every
device activity one wrapper call causes, by torch.profiler over 10 calls
(name, count per call, mean microseconds). Run on an older checkout (as
an A/B against a parent), it skips a staging form that checkout lacks.
Without a card it exits 2.
"""
from __future__ import annotations

import subprocess
import sys

import numpy as np
import torch

W, H = 3840, 2160
REPS = 20


def cuda_ms(fn, reps: int = REPS) -> float:
    """Mean milliseconds of fn() by CUDA events, after one warm-up call."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_activities(fn, calls: int = 10):
    """[(name, launches per call, mean us)] of the device activities that
    `calls` calls of fn() cause, by torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    rows = []
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        total = getattr(ev, "self_device_time_total", None)
        if total is None:
            total = ev.self_cuda_time_total
        if ev.count:
            rows.append((ev.key, ev.count / calls, total / ev.count))
    return rows


def report(label: str, fn) -> None:
    print(f"{label}: {cuda_ms(fn):.4f} ms a call (CUDA events)", flush=True)
    rows = device_activities(fn)
    if not rows:
        print("  torch.profiler saw no device time", flush=True)
    for name, per_call, us in rows:
        print(f"  device: {name[:110]} x{per_call:g} a call, {us:.2f} us",
              flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("kernel_profile: torch sees no CUDA device", file=sys.stderr)
        return 2
    from . import format as fmt
    from ._bits import to_i32
    from .kernels import _build
    from .kernels import encode_stage as kstage
    from .kernels import slide as kslide
    from .models import decode_pipeline, pipeline
    from .ops import compact
    from .utils import testimages

    dev = torch.device("cuda", 0)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
        .splitlines()[0], flush=True)
    so = _build.build()
    _build.lib()
    for line in so.with_suffix(".log").read_text().splitlines():
        if any(k in line for k in ("Compiling entry", "registers", "spill")):
            print(f"  ptxas: {line.strip()}", flush=True)

    n = W * H
    npc = decode_pipeline.bucket_size(n)

    def px4_of(frame, ch):
        px4 = np.zeros((npc, 4), np.uint8)
        px4[:n] = pipeline.force_rgba(frame, fmt.StreamDesc(W, H, ch))
        return torch.from_numpy(px4).to(dev)

    mixed = px4_of(testimages.mixed(W, H, 4, seed=3), 4)
    ch = pipeline.encode_stage_chunks(mixed, n)
    ev = compact.wordsum_events(ch.lo, ch.hi, ch.lens, 20480)
    val, aux = to_i32(ev.val), ev.aux.to(torch.int32)
    del ch, ev
    print(f"slide_val planes {tuple(val.shape)}", flush=True)
    report("slide_val wrapper", lambda: kslide.slide_val(val, aux))
    print(f"slide_val output allocation alone (torch.zeros_like): "
          f"{cuda_ms(lambda: torch.zeros_like(val)):.4f} ms", flush=True)
    del val, aux
    photo = px4_of(testimages.photo(W, H, 3, seed=3), 3)
    for label, px4 in (("mixed RGBA", mixed), ("photo RGB", photo)):
        for name in ("encode_stage_pallas", "encode_stage_words",
                     "encode_stage_planes"):
            stage = getattr(kstage, name, None)
            if stage is not None:
                report(f"{name} wrapper, {label}, N={npc}",
                       lambda: stage(px4, n))
    return 0


if __name__ == "__main__":
    sys.exit(main())
