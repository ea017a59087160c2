#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (qoi_tpu_torch) on one GPU.

Run from the repository root on a machine with a CUDA card:

    python3 chip_smoke.py

It builds the CUDA kernels from qoi_tpu_torch/csrc/, holds each kernel
against its plain PyTorch twin at the shapes the 4K main path gives it
(results must be exactly equal), then drives the main path through the
public entry points on 3840x2160 frames:

  * encode 8 RGBA `mixed` frames (seeds 3..10) and 1 RGB `photo` frame
    with qoi_tpu_torch.encode, each byte-identical to the C++ oracle;
  * decode 8 `photo` and 8 `mixed` streams with decode_v3.decode_group
    and qoi_tpu_torch.decode, pixel-identical to the sources;
  * decode the adversarial stream (INDEX reads of a never-written slot),
    which must fail the device fixpoint and match the oracle through the
    native ladder;

and fails unless every kernel was launched by that run. Earlier lines
report the card (name and power limit from nvidia-smi), the build, each
kernel's time beside its twin's, and the encode/decode rates; one JSON
line lists the kernels. The last line is the JSON result object. Any
failure raises and exits non-zero; without a CUDA device it exits 2 and
prints no result.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np

W, H = 3840, 2160
NFRAMES = 8
SEEDS = range(3, 3 + NFRAMES)


def log(msg: str) -> None:
    print(msg, flush=True)


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise RuntimeError(f"FAILED: {msg}")


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds of fn() on the card, by CUDA events (one warm-up
    call first)."""
    import torch

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


def compare(name, got, want):
    """Exact comparison of two int32 kernel outputs; returns max |err|."""
    err = int((got.long() - want.long()).abs().max()) if got.numel() else 0
    check(got.shape == want.shape and err == 0,
          f"{name}: kernel differs from its twin (max abs err {err})")
    return err


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 2

    import qoi_tpu_torch
    from qoi_tpu import format as fmt
    from qoi_tpu import oracle
    from qoi_tpu.utils import testimages
    from qoi_tpu_torch._bits import to_i32
    from qoi_tpu_torch.kernels import _build
    from qoi_tpu_torch.kernels import block_maps as kbm
    from qoi_tpu_torch.kernels import expand as kexp
    from qoi_tpu_torch.kernels import slide as kslide
    from qoi_tpu_torch.models import buckets, decode_v3, pipeline
    from qoi_tpu_torch.ops import compact

    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    log("card (nvidia-smi name, power.limit):")
    log(smi.splitlines()[0])
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device "
        f"{torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    check(oracle.available(), "the C++ oracle (cpp/, make) is not available")

    # ---- build -------------------------------------------------------
    t0 = time.perf_counter()
    so = _build.build()
    _build.lib()
    log(f"build: {so.name} in {time.perf_counter() - t0:.3f} s")
    for line in so.with_suffix(".log").read_text().splitlines():
        if "registers" in line or "Compiling entry" in line:
            log(f"  ptxas: {line.strip()}")

    desc4 = fmt.StreamDesc(W, H, 4)
    n = desc4.num_pixels
    t0 = time.perf_counter()
    mixed = [testimages.mixed(W, H, 4, seed=s) for s in SEEDS]
    photo = [testimages.photo(W, H, 4, seed=s) for s in SEEDS]
    photo_rgb = testimages.photo(W, H, 3, seed=3)
    mixed_streams = [oracle.encode(f, desc4) for f in mixed]
    photo_streams = [oracle.encode(f, desc4) for f in photo]
    log(f"inputs: {2 * NFRAMES + 1} 4K frames + oracle streams in "
        f"{time.perf_counter() - t0:.1f} s")

    # ---- each kernel against its twin at the 4K main-path shapes -----
    kernels = {}

    # A: the events of a 4K mixed frame, as encode_device_wordsum builds them
    px4 = np.zeros((buckets.bucket_size(n), 4), np.uint8)
    px4[:n] = pipeline.force_rgba(mixed[0], desc4)
    ch = pipeline.encode_stage_chunks(torch.from_numpy(px4).to(dev), n)
    ev = compact.wordsum_events(ch.lo, ch.hi, ch.lens, 20480)
    val, aux = to_i32(ev.val), ev.aux.to(torch.int32)
    del ch, ev
    err = compare("slide_val", kslide.slide_val(val, aux),
                  kslide.slide_val_plain(val, aux))
    kernels["slide_val"] = dict(
        route="cuda", source="qoi_tpu_torch/csrc/slide.cu",
        replaces="qoi_tpu/kernels/slide.py:148", max_abs_err=err,
        ms=cuda_ms(lambda: kslide.slide_val(val, aux), 20),
        plain_ms=cuda_ms(lambda: kslide.slide_val_plain(val, aux), 3))
    log(f"kernel slide_val {tuple(val.shape)}: equal to twin; "
        f"{kernels['slide_val']['ms']:.4f} ms vs plain "
        f"{kernels['slide_val']['plain_ms']:.4f} ms")
    del val, aux

    # B and C: the decode intermediates of a 4K mixed stream
    s = mixed_streams[0]
    raw = np.frombuffer(s, np.uint8)[fmt.HEADER_SIZE:]
    m = buckets.bucket_size_fine(len(raw))
    pad = np.zeros(m, np.uint8)
    pad[: len(raw)] = raw
    clen = len(s) - fmt.HEADER_SIZE - fmt.TRAILER_SIZE
    data = torch.from_numpy(pad).to(dev)
    b = decode_v3._scan_block_len(m)
    starts, cls, r6, d32, lit32, npix = decode_v3._fields(data, clen)
    w0, _ = decode_v3._initial_w(cls, r6, d32, lit32, npix)
    w0 = torch.where(starts, w0, 0)
    meta = decode_v3._pos_major(
        (cls | (r6 << 9) | (w0 << 3)).to(torch.int32), m, b)
    d32_p = decode_v3._pos_major(to_i32(d32), m, b)
    lit32_p = decode_v3._pos_major(to_i32(lit32), m, b)
    del starts, cls, r6, d32, lit32, npix, w0
    got = kbm.block_maps(meta, d32_p, lit32_p)
    t0 = time.perf_counter()
    want = kbm.block_maps_plain(meta, d32_p, lit32_p)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    err = max(compare(f"block_maps[{i}]", g, w_)
              for i, (g, w_) in enumerate(zip(got, want)))
    del got, want
    kernels["block_maps"] = dict(
        route="cuda", source="qoi_tpu_torch/csrc/block_maps.cu",
        replaces="qoi_tpu/models/decode_v3.py:300", max_abs_err=err,
        ms=cuda_ms(lambda: kbm.block_maps(meta, d32_p, lit32_p), 5),
        plain_ms=plain_ms)
    log(f"kernel block_maps (b, nb) = {tuple(meta.shape)}: equal to twin; "
        f"{kernels['block_maps']['ms']:.4f} ms vs plain "
        f"{plain_ms:.4f} ms (plain: one run, host clock)")
    del meta, d32_p, lit32_p

    px, _, _, pix_off, conv, rounds = decode_v3._decode_core(data, clen)
    check(conv, "4K mixed stream did not converge for the expand input")
    pix_off, px32 = pix_off.to(torch.int32), to_i32(px)
    npc = buckets.bucket_size(n)
    err = compare("expand_px", kexp.expand_px(pix_off, px32, npc),
                  kexp.expand_px_xla(pix_off, px32, npc))
    kernels["expand_px"] = dict(
        route="cuda", source="qoi_tpu_torch/csrc/expand.cu",
        replaces="qoi_tpu/kernels/expand.py:621", max_abs_err=err,
        ms=cuda_ms(lambda: kexp.expand_px(pix_off, px32, npc), 20),
        plain_ms=cuda_ms(lambda: kexp.expand_px_xla(pix_off, px32, npc), 5))
    log(f"kernel expand_px M={m} n_px_cap={npc}: equal to twin; "
        f"{kernels['expand_px']['ms']:.4f} ms vs plain "
        f"{kernels['expand_px']['plain_ms']:.4f} ms (incl. the cumsum)")
    del data, px, pix_off, px32

    # ---- the main path, counted --------------------------------------
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()

    # encode: 8 RGBA mixed + 1 RGB photo, byte-identical to the oracle
    ts = []
    for i, frame in enumerate(mixed):
        t0 = time.perf_counter()
        got = qoi_tpu_torch.encode(frame, device=dev)
        ts.append(time.perf_counter() - t0)
        check(got == mixed_streams[i], f"encode mixed seed {SEEDS[i]}")
    log(f"encode {NFRAMES}x4K RGBA mixed via qoi_tpu_torch.encode: "
        f"byte-identical to oracle; mean {np.mean(ts) * 1e3:.3f} ms/frame "
        f"(first {ts[0] * 1e3:.3f}, min {min(ts) * 1e3:.3f}), "
        f"{NFRAMES * n / 1e6 / sum(ts):.3f} Mpx/s")
    t0 = time.perf_counter()
    got = qoi_tpu_torch.encode(photo_rgb, device=dev)
    dt = time.perf_counter() - t0
    check(got == oracle.encode(photo_rgb, fmt.StreamDesc(W, H, 3)),
          "encode RGB photo")
    log(f"encode 1x4K RGB photo: byte-identical to oracle; {dt * 1e3:.3f} ms, "
        f"{n / 1e6 / dt:.3f} Mpx/s")

    # decode: decode_group (device pixels vs sources) and the facade
    for label, streams, frames in (("photo", photo_streams, photo),
                                   ("mixed", mixed_streams, mixed)):
        mcap = buckets.bucket_size_fine(
            max(len(x) for x in streams) - fmt.HEADER_SIZE)
        bodies = np.zeros((NFRAMES, mcap), np.uint8)
        clens = []
        for i, x in enumerate(streams):
            r = np.frombuffer(x, np.uint8)[fmt.HEADER_SIZE:]
            bodies[i, : len(r)] = r
            clens.append(len(x) - fmt.HEADER_SIZE - fmt.TRAILER_SIZE)
        batch = torch.from_numpy(bodies).to(dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out, conv, rounds = decode_v3.decode_group(batch, clens, npc)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        check(bool(conv.all()), f"decode_group {label}: not converged")
        for i, frame in enumerate(frames):
            want = to_i32(torch.from_numpy(
                np.ascontiguousarray(frame).reshape(-1, 4).view(np.uint32)
                .reshape(-1).astype(np.int64)).to(dev))
            check(bool((out[i, :n] == want).all()),
                  f"decode_group {label} frame {i}: pixels differ")
        log(f"decode {NFRAMES}x4K {label} via decode_group: pixel-identical "
            f"to source; {dt / NFRAMES * 1e3:.3f} ms/frame, "
            f"{NFRAMES * n / 1e6 / dt:.3f} Mpx/s; rounds per stream "
            f"{rounds.tolist()}")
        del batch, out
        ts = []
        for i, (x, frame) in enumerate(zip(streams, frames)):
            t0 = time.perf_counter()
            img, _ = qoi_tpu_torch.decode(x, device=dev)
            ts.append(time.perf_counter() - t0)
            check(np.array_equal(img, frame),
                  f"qoi_tpu_torch.decode {label} frame {i}: pixels differ")
        log(f"decode {NFRAMES}x4K {label} via qoi_tpu_torch.decode: "
            f"pixel-identical; mean {np.mean(ts) * 1e3:.3f} ms/frame, "
            f"{NFRAMES * n / 1e6 / sum(ts):.3f} Mpx/s (incl. upload and "
            f"pixel fetch)")

    # adversarial: must fail the device fixpoint and take the ladder
    adv = fmt.pack_header(desc4) + b"\x05" * n + fmt.TRAILER
    araw = np.frombuffer(adv, np.uint8)[fmt.HEADER_SIZE:]
    apad = np.zeros(buckets.bucket_size_fine(len(araw)), np.uint8)
    apad[: len(araw)] = araw
    _, aconv, arounds = decode_v3._decode_device(
        torch.from_numpy(apad).to(dev), len(adv) - 22, npc)
    check(not aconv, "adversarial stream converged on the device")
    t0 = time.perf_counter()
    img, _ = qoi_tpu_torch.decode(adv, device=dev)
    dt = time.perf_counter() - t0
    check(np.array_equal(img, oracle.decode(adv)[0]), "adversarial decode")
    log(f"decode 1x4K adversarial: device fixpoint bailed after {arounds} "
        f"rounds, ladder result equals oracle.decode; {dt * 1e3:.3f} ms, "
        f"{n / 1e6 / dt:.3f} Mpx/s")

    torch.cuda.synchronize()
    counts = dict(_build.launches)
    log(f"launches in the main-path run: {counts}; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    for name in kernels:
        check(counts[name] > 0,
              f"kernel {name} never launched by the main path")
        kernels[name]["launches"] = counts[name]

    log("card (nvidia-smi name, power.limit):")
    log(smi.splitlines()[0])
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms")
    log(json.dumps({"kernels": [
        {k: ({"name": name} | v)[k] for k in keys}
        for name, v in kernels.items()]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
