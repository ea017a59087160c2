"""Where the time of the slide_val and staging kernels goes, on the card.

Run from the repository root on a machine with a CUDA card:

    python3 -m qoi_tpu_torch.kernel_profile [--only words,planes] [--sass]

It builds the kernels, prints the ptxas lines of the build (registers,
spills), then, at the 4K shapes `chip_smoke.py` uses (the slide planes of a
3840x2160 mixed RGBA frame's word-sum events, and the staging of that
frame and of a 4K RGB photo frame in its three forms: fused, words and
planes), times each wrapper call with CUDA events (mean of 20 calls after
one warm-up), the slide wrapper's output allocation alone, and lists every
device activity one wrapper call causes, by torch.profiler over 10 calls
(name, count per call, mean microseconds), with the kernels' and the
memsets' device time a call apart. `--only` picks among slide, fused,
words and planes. `--sass` prints, for
each staging kernel of the built library, its SASS instruction count
(`cuobjdump -sass`) in sections cut at each block barrier (BAR), so that
a phase's instructions can be told from the set-up's and the
look-back's. Run on an older checkout (as an A/B against a parent, the
two in turns in one call), it skips a staging form that checkout lacks.
Without a card it exits 2.
"""
from __future__ import annotations

import argparse
import os
import re
import shutil
import subprocess
import sys

import numpy as np
import torch

W, H = 3840, 2160
REPS = 20
STAGES = {"fused": "encode_stage_pallas", "words": "encode_stage_words",
          "planes": "encode_stage_planes"}


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
    memset = sum(c * us for name, c, us in rows
                 if name.lower().startswith("memset"))
    kernel = sum(c * us for name, c, us in rows) - memset
    print(f"  device a call: kernels {kernel:.2f} us, memsets {memset:.2f} us",
          flush=True)


def _cuobjdump() -> str:
    found = shutil.which("cuobjdump")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    return os.path.join(home, "bin", "cuobjdump")


def sass_sections(so) -> dict:
    """{kernel name: [instructions of each section]} for the staging
    kernels of the library, by `cuobjdump -sass` (see count_sections)."""
    return count_sections(subprocess.run(
        [_cuobjdump(), "-sass", str(so)], capture_output=True, text=True,
        check=True).stdout)


def count_sections(sass: str) -> dict:
    """{kernel name: [instructions of each section]} of the kernels whose
    names hold "stage" in a `cuobjdump -sass` listing; sections end at
    each block barrier (BAR.SYNC / BAR.RED; not BAR.ARV), which stays in
    the section it ends."""
    kernels, name = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1) if "stage" in m.group(1) else None
            if name:
                kernels[name] = [0]
            continue
        if name is None:
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][\w.]*)",
                     line)
        if not m:
            continue
        kernels[name][-1] += 1
        if m.group(1).startswith("BAR.") and not m.group(1).startswith(
                "BAR.ARV"):
            kernels[name].append(0)
    return kernels


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="kernel_profile")
    ap.add_argument("--only", default="slide,fused,words,planes")
    ap.add_argument("--sass", action="store_true")
    args = ap.parse_args(argv)
    only = set(args.only.split(","))
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
    if args.sass:
        for name, secs in sass_sections(so).items():
            print(f"  sass: {name}: {sum(secs)} instructions, by barrier "
                  f"section {secs}", flush=True)

    n = W * H
    npc = decode_pipeline.bucket_size(n)

    def px4_of(frame, ch):
        px4 = np.zeros((npc, 4), np.uint8)
        px4[:n] = pipeline.force_rgba(frame, fmt.StreamDesc(W, H, ch))
        return torch.from_numpy(px4).to(dev)

    mixed = px4_of(testimages.mixed(W, H, 4, seed=3), 4)
    if "slide" in only:
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
        for form, name in STAGES.items():
            stage = getattr(kstage, name, None)
            if form in only and stage is not None:
                report(f"{name} wrapper, {label}, N={npc}",
                       lambda: stage(px4, n))
    return 0


if __name__ == "__main__":
    sys.exit(main())
