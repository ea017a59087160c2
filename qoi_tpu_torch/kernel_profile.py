"""Where the time of the slide_val, compaction, staging and one-pass scan
kernels goes, on the card.

Run from the repository root on a machine with a CUDA card:

    python3 -m qoi_tpu_torch.kernel_profile [--only words,resolve] [--sass]

It builds the kernels, prints the ptxas lines of the build (registers,
spills), then, at the 4K shapes `chip_smoke.py` uses, times each wrapper
call with CUDA events (mean of 20 calls after one warm-up) and lists every
device activity one wrapper call causes, by torch.profiler over 10 calls
(name, count per call, mean microseconds), with the kernels' and the
memsets' device time a call apart, and each kernel's mean device time a
launch. `--only` picks among:
  slide    the slide planes of a 3840x2160 mixed RGBA frame's word-sum
           events (and the output allocation alone);
  compact  the word compaction kernel (compact_words) on that frame's
           and a 4K RGB photo frame's records, and the word-sum route it
           replaced on the card (the events, slide_val, the windowed
           add);
  fused, words, planes
           the staging of that frame and of a 4K RGB photo frame;
  resolve  v2's resolve_scan on the round-0 leaves of the 4K photo and
           mixed streams (seed 3), padded as `decode_v2.decode` pads them;
  scans    the five other entries of csrc/blocked_scan.cu (fsm_scan,
           fsm_starts, initial_scan, initial_w_scan, anch_scan) at the 4K
           mixed stream's shapes.
`--sass` prints, for each staging, resolve and compaction kernel of the built
library, its SASS instruction count (`cuobjdump -sass`) in sections cut
at each block barrier (BAR), so that a phase's instructions can be told
from the set-up's and the look-back's. Run on an older checkout (as an A/B
against a parent, the two in turns in one call, with this file and
models/decode_v2.py and decode_v3.py copied in for their input
helpers), it skips a staging form that checkout lacks and times that
checkout's resolve_scan. Without a card it exits 2.
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
ONLY = "slide,compact,fused,words,planes,resolve,scans"
#: SASS listed by --sass: the staging kernels, the resolve scan's kernel
#: (and, in an older checkout, the one-pass template's resolve entry), the
#: compaction kernel
SASS_KEYS = ("stage", "resolve", "one_pass_kernelILi5E", "compact_kernel")


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
    # a launch's mean, which holds where the profiler misses a call's
    # events (it then reports fewer than one a call)
    for name, _, us in rows:
        if not name.lower().startswith("memset"):
            print(f"  device a launch: {us:.2f} us, {name[:60]}", flush=True)


def _cuobjdump() -> str:
    found = shutil.which("cuobjdump")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    return os.path.join(home, "bin", "cuobjdump")


def sass_sections(so) -> dict:
    """{kernel name: [instructions of each section]} for the staging,
    resolve and compaction kernels of the library, by `cuobjdump -sass` (see
    count_sections)."""
    return count_sections(subprocess.run(
        [_cuobjdump(), "-sass", str(so)], capture_output=True, text=True,
        check=True).stdout, SASS_KEYS)


def count_sections(sass: str, keys=("stage",)) -> dict:
    """{kernel name: [instructions of each section]} of the kernels whose
    names hold one of `keys` in a `cuobjdump -sass` listing; sections end
    at each block barrier (BAR.SYNC / BAR.RED; not BAR.ARV), which stays
    in the section it ends."""
    kernels, name = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1) if any(k in m.group(1) for k in keys) \
                else None
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


def ptxas_of(lines, key: str) -> list:
    """The ptxas lines (registers, shared memory, spills) of the entry
    whose name holds `key`, from an `nvcc -Xptxas -v` log."""
    out, on = [], False
    for line in lines:
        if "Compiling entry" in line:
            on = key in line
        elif on and any(k in line for k in ("registers", "smem", "spill")):
            out.append(line.split(":", 1)[-1].strip())
    return out


def profile_resolve(dev) -> None:
    """resolve_scan at the 4K photo and mixed streams' round-0 leaves."""
    from . import format as fmt
    from . import oracle
    from .kernels import blocked_scan as kbs
    from .models import decode_v2
    from .utils import testimages

    for kind in ("photo", "mixed"):
        img = getattr(testimages, kind)(W, H, 4, seed=3)
        rflag, val = decode_v2.round0_leaves(*decode_v2.stream_body(
            oracle.encode(img, fmt.StreamDesc(W, H, 4)), dev))
        del img
        m = rflag.shape[1]
        report(f"resolve_scan wrapper, 4K {kind} stream's leaves, (4, {m}); "
               f"bound {12 * m / 3.35e9:.4f} ms (12 B a position at "
               f"3.35 TB/s)", lambda: kbs.resolve_scan(rflag, val))
        del rflag, val


def profile_scans(dev) -> None:
    """The five other one-pass entries at the 4K mixed stream's shapes,
    as chip_smoke.py builds them."""
    from . import format as fmt
    from . import oracle
    from .kernels import blocked_scan as kbs
    from .models import decode_pipeline, decode_v3
    from .utils import testimages

    s = oracle.encode(testimages.mixed(W, H, 4, seed=3),
                      fmt.StreamDesc(W, H, 4))
    raw = np.frombuffer(s, np.uint8)[fmt.HEADER_SIZE:]
    pad = np.zeros(decode_pipeline.bucket_size_fine(len(raw)), np.uint8)
    pad[: len(raw)] = raw
    data = torch.from_numpy(pad).to(dev)
    clen = len(s) - fmt.HEADER_SIZE - fmt.TRAILER_SIZE
    starts, leaf_w, npix32, leaf_a = decode_v3.scan_inputs(data, clen)
    m = data.shape[0]
    for name, fn in (
            ("fsm_scan", lambda: kbs.fsm_scan(data)),
            ("fsm_starts", lambda: kbs.fsm_starts(data, clen)),
            ("initial_scan", lambda: kbs.initial_scan(leaf_w, npix32)),
            ("initial_w_scan", lambda: kbs.initial_w_scan(data, starts)),
            ("anch_scan", lambda: kbs.anch_scan(leaf_a))):
        report(f"{name} wrapper, 4K mixed stream, M={m}", fn)


def profile_compact(ch, capacity: int, label: str) -> None:
    """The compaction of one frame's staged records: the kernel (skipped
    in a checkout without it) and the word-sum route on the card."""
    from ._bits import to_i32
    from .kernels import slide as kslide
    from .ops import compact

    def wordsum_route():
        ev = compact.wordsum_events(ch.lo, ch.hi, ch.lens, 20480)
        val = kslide.slide_val(to_i32(ev.val), ev.aux.to(torch.int32))
        return compact._wordsum_assemble(val, ev.wbase, ev.total, ev.v_all,
                                         capacity)

    total = int(ch.lens.to(torch.int64).sum())
    print(f"compaction of {ch.lens.shape[0]} records, {total} stream bytes "
          f"({label})", flush=True)
    try:
        from .kernels import compact_words as kcw
    except ImportError:
        kcw = None
    if kcw is not None:
        report(f"compact_words wrapper, {label}",
               lambda: kcw.compact_words(ch.lo, ch.hi, ch.lens, capacity))
    report(f"word-sum route, {label}", wordsum_route)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="kernel_profile")
    ap.add_argument("--only", default=ONLY)
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
    if "resolve" in only:
        profile_resolve(dev)
    if "scans" in only:
        profile_scans(dev)
    if not only & {"slide", "compact", "fused", "words", "planes"}:
        return 0

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
    if "compact" in only:
        for label, px4 in (("mixed RGBA", mixed), ("photo RGB", photo)):
            profile_compact(pipeline.encode_stage_chunks(px4, n), npc * 6,
                            label)
    for label, px4 in (("mixed RGBA", mixed), ("photo RGB", photo)):
        for form, name in STAGES.items():
            stage = getattr(kstage, name, None)
            if form in only and stage is not None:
                report(f"{name} wrapper, {label}, N={npc}",
                       lambda: stage(px4, n))
    return 0


if __name__ == "__main__":
    sys.exit(main())
