"""Headline benchmark of the port: batched 4K RGBA encode and decode
throughput on one card (the counterpart of the repository's bench.py).

    python -m qoi_tpu_torch.headline                 # on a CUDA card
    python -m qoi_tpu_torch.headline --check-only --device cpu \\
        --width 64 --height 48 --frames 2 --dispatch 1

What it runs, at --width x --height (default 3840x2160) RGBA:
- encode: --frames `testimages.mixed` frames (seeds --seed ..), each
  dispatched --dispatch times through `pipeline.encode_device_wordsum`
  (8 x 4 = 32 encodes a rep by default); one combined fetch of the totals
  ends each rep;
- decode: the oracle's streams of --frames `testimages.photo` frames and
  of the mixed ones, padded to one bucket and repeated --dispatch times
  (32 streams a class by default), through `decode_v3.decode_group`;
- adversarial: a stream of 0x05 bytes (INDEX reads of a never-written
  slot) through `decode_v3.decode`: the device fixpoint stalls and the
  ladder decodes it; the best of 3.

Every result is gated before anything is timed: each encode equals
`oracle.encode` byte for byte, each decode equals its source pixels
(compared on the device) with `converged` true, and the adversarial image
equals `oracle.decode`'s. A failed gate prints a `verify_failed` line and
exits 1. Times are the host clock between two `torch.cuda.synchronize()`
calls (`utils/profiling.device_sync_times`), best of --reps; the
per-rep times go to stderr. The baselines are the single-threaded C++
oracle's rates on this host over the same frames: encode over the mixed
frames, decode over the photo and mixed streams, best of 3.

Prints one JSON line on stdout (the keys and units of bench.py, plus
`baseline_encode_mpxs`, `baseline_decode_mpxs`, `device`,
`power_limit_w` and `reps`); diagnostics (ms a batch, KiB a stream, peak
device memory of each phase) go to stderr. Timing needs a CUDA device:
without --check-only any other device raises. --check-only runs the
gates on any device and prints `{"verified": true, "device": ...}` and no
rate.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional

import numpy as np
import torch

from . import _device
from . import format as fmt
from . import oracle
from .models import decode_pipeline, decode_v3, pipeline
from .utils import profiling, testimages

W, H = 3840, 2160
FRAMES = 8
DISPATCH = 4
REPS = 10
SEED = 3
METRIC = "encode_4k_rgba_batch_throughput"
#: the keys of the result line after bench.py's own
EXTRA_KEYS = ("baseline_encode_mpxs", "baseline_decode_mpxs", "device",
              "power_limit_w", "reps")


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


class GateFailed(Exception):
    """A result differs from the oracle's bytes or the source pixels."""


def _gate(ok: bool, what: str) -> None:
    if not ok:
        raise GateFailed(what)


def _power_limit_w(dev: torch.device) -> float:
    """The card's power limit in watts, as nvidia-smi reports it."""
    out = subprocess.run(
        ["nvidia-smi", "-i", str(dev.index or 0),
         "--query-gpu=power.limit", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True).stdout
    return float(out.strip().splitlines()[0])


def _peak_reset(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)


def _peak_gib(dev: torch.device) -> str:
    if dev.type != "cuda":
        return "not measured"
    return f"{torch.cuda.max_memory_allocated(dev) / 2**30:.3f} GiB"


def _times_line(label: str, ts: List[float]) -> None:
    log(f"{label}: per-rep ms {[round(t * 1e3, 3) for t in ts]}, median "
        f"{statistics.median(ts) * 1e3:.3f} ms, {len(ts)} samples")


def _best_of(fn, reps: int) -> float:
    """Best seconds of `reps` runs of fn() on the host clock."""
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t0)
    return best


def _packed_px(frame: np.ndarray, desc: fmt.StreamDesc) -> np.ndarray:
    """(N,) int32: the frame's RGBA pixels as little-endian words."""
    return np.ascontiguousarray(pipeline.force_rgba(frame, desc)).view(
        np.int32).reshape(-1)


def _parse(argv):
    ap = argparse.ArgumentParser(
        prog="python -m qoi_tpu_torch.headline",
        description="Batched 4K RGBA encode/decode throughput of the port, "
                    "every result gated against the oracle and the sources "
                    "before it is timed.")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; timing needs a card)")
    ap.add_argument("--check-only", action="store_true",
                    help="run the gates only, on any device; print no rate")
    ap.add_argument("--reps", type=int, default=REPS,
                    help=f"timed reps, the best is reported (default {REPS})")
    ap.add_argument("--seed", type=int, default=SEED,
                    help=f"seed of the first frame (default {SEED})")
    ap.add_argument("--frames", type=int, default=FRAMES,
                    help=f"unique frames a class (default {FRAMES})")
    ap.add_argument("--dispatch", type=int, default=DISPATCH,
                    help="encode dispatches of each frame and decode copies "
                         f"of each stream (default {DISPATCH})")
    ap.add_argument("--width", type=int, default=W)
    ap.add_argument("--height", type=int, default=H)
    opts = ap.parse_args(argv)
    if min(opts.reps, opts.frames, opts.dispatch) < 1:
        ap.error("--reps, --frames and --dispatch must be at least 1")
    return opts


def main(argv: Optional[List[str]] = None) -> int:
    opts = _parse(argv)
    dev = _device(opts.device)
    if not opts.check_only and dev.type != "cuda":
        raise RuntimeError(
            f"timing needs a CUDA device, got {opts.device!r}; --check-only "
            "runs the gates on any device")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    log(f"device: {name}")
    try:
        result = _run(opts, dev, name)
    except GateFailed as e:
        log(f"VERIFY FAILED: {e}")
        # bench.py's verify_failed line (its zeros are placeholders, no
        # rate), with the failed gate and the device
        print(json.dumps({"metric": METRIC, "value": 0.0, "unit": "Mpx/s",
                          "vs_baseline": 0.0, "decode_mpxs": 0.0,
                          "decode_vs_baseline": 0.0, "verify_failed": True,
                          "failed": str(e), "device": name}), flush=True)
        return 1
    print(json.dumps(result), flush=True)
    return 0


def _run(opts, dev: torch.device, name: str) -> dict:
    desc = fmt.StreamDesc(opts.width, opts.height, 4)
    n = desc.num_pixels
    cap = -(-n // 1024) * 1024
    nf, nd = opts.frames, opts.dispatch
    seeds = range(opts.seed, opts.seed + nf)

    # the frames and the oracle's streams are made on host threads: numpy
    # and the oracle's C calls release the interpreter lock for most of it
    with ThreadPoolExecutor(8) as pool:
        made = [pool.submit(testimages.mixed, desc.width, desc.height, 4,
                            seed=k) for k in seeds]
        made += [pool.submit(testimages.photo, desc.width, desc.height, 4,
                             seed=k) for k in seeds]
        frames = [f.result() for f in made]
        streams = list(pool.map(lambda f: oracle.encode(f, desc), frames))
    mixed, photo = frames[:nf], frames[nf:]
    mixed_streams, photo_streams = streams[:nf], streams[nf:]

    # ---- encode: nf frames, nd dispatches each -------------------------
    batch = np.zeros((nf, cap, 4), np.uint8)
    for i, f in enumerate(mixed):
        batch[i, :n] = pipeline.force_rgba(f, desc)
    xs = [torch.from_numpy(batch[i]).to(dev) for i in range(nf)]
    del batch

    def encode_frames():
        outs = [pipeline.encode_device_wordsum(x, n) for x in xs * nd]
        # the combined totals are the one thing a rep fetches
        return outs, torch.stack([t for _, t in outs]).cpu()

    outs, totals = encode_frames()
    for i, (words, _) in enumerate(outs):
        tot = int(totals[i])
        body = words[: -(-tot // 4)].cpu().numpy().view(np.uint8)[:tot]
        _gate(fmt.pack_header(desc) + body.tobytes() + fmt.TRAILER
              == mixed_streams[i % nf],
              f"encode {i} (mixed seed {seeds[i % nf]}) differs from "
              "oracle.encode")
    log(f"verified: all {nf * nd} encodes byte-identical to oracle.encode")
    enc_kib = int(totals[0]) / 1024
    del outs

    # ---- decode: photo and mixed, nd copies of each stream ------------
    mcap = decode_pipeline.bucket_size_fine(
        max(len(s) for s in streams) - fmt.HEADER_SIZE)
    npc = decode_pipeline.bucket_size(n)

    def device_batch(strms):
        bodies = np.zeros((nf, mcap), np.uint8)
        clens = []
        for i, s in enumerate(strms):
            raw = np.frombuffer(s, np.uint8)[fmt.HEADER_SIZE:]
            bodies[i, : len(raw)] = raw
            clens.append(len(s) - fmt.HEADER_SIZE - fmt.TRAILER_SIZE)
        # copies made on the device, not uploaded again
        return (torch.from_numpy(bodies).to(dev).repeat(nd, 1),
                clens * nd)

    classes = {}
    for label, strms, srcs in (("photo", photo_streams, photo),
                               ("mixed", mixed_streams, mixed)):
        db, dc = device_batch(strms)
        want = [torch.from_numpy(_packed_px(f, desc)).to(dev) for f in srcs]
        out, conv, rounds = decode_v3.decode_group(db, dc, npc)
        for i in range(nf * nd):
            _gate(bool(conv[i]), f"decode {label} stream {i} did not "
                  "converge")
            _gate(bool(torch.equal(out[i, :n], want[i % nf])),
                  f"decode {label} stream {i} differs from its source")
        log(f"verified: all {nf * nd} {label} decodes pixel-identical to "
            f"the source (on the device), converged; rounds "
            f"{sorted(set(rounds.tolist()))}")
        del out, want
        classes[label] = (db, dc)

    adv = fmt.pack_header(desc) + b"\x05" * n + fmt.TRAILER
    want_adv, _ = oracle.decode(adv)
    img, _ = decode_v3.decode(adv, 0, dev)
    _gate(np.array_equal(img, want_adv),
          "adversarial decode differs from oracle.decode")
    log("verified: the adversarial decode equals oracle.decode")

    if opts.check_only:
        return {"verified": True, "device": name}

    # ---- timing, after every gate ---------------------------------------
    reps = opts.reps
    _peak_reset(dev)
    ts = profiling.device_sync_times(lambda: encode_frames()[1], reps, dev)
    enc_peak = _peak_gib(dev)
    _times_line("encode", ts)
    enc_n = nf * nd
    enc_mpxs = enc_n * n / 1e6 / min(ts)
    log(f"encode {enc_n}x{desc.width}x{desc.height} RGBA mixed: "
        f"{min(ts) * 1e3:.3f} ms/batch, {enc_mpxs:.3f} Mpx/s, "
        f"{enc_kib:.0f} KiB/stream ({100 * enc_kib * 1024 / (n * 4):.1f}%), "
        f"peak device memory {enc_peak}")
    del xs

    dec_mpxs = {}
    for label, (db, dc) in classes.items():
        def decode_frames(db=db, dc=dc, label=label):
            _, conv, _ = decode_v3.decode_group(db, dc, npc)
            _gate(bool(conv.all()), f"decode {label}: fixpoint did not "
                  "converge in a timed rep")

        _peak_reset(dev)
        ts = profiling.device_sync_times(decode_frames, reps, dev)
        _times_line(f"decode[{label}]", ts)
        mpxs = nf * nd * n / 1e6 / min(ts)
        log(f"decode[{label}] {nf * nd}x{desc.width}x{desc.height} RGBA: "
            f"{min(ts) * 1e3:.3f} ms/batch, {mpxs:.3f} Mpx/s, peak device "
            f"memory {_peak_gib(dev)}")
        dec_mpxs[label] = mpxs
    del classes

    _peak_reset(dev)
    ts = profiling.device_sync_times(lambda: decode_v3.decode(adv, 0, dev),
                                     3, dev)
    _times_line("decode[adversarial]", ts)
    adv_mpxs = n / 1e6 / min(ts)
    log(f"decode[adversarial] 1x{desc.width}x{desc.height} INDEX-unwritten: "
        f"min {min(ts) * 1e3:.3f} ms, {adv_mpxs:.3f} Mpx/s (device stall "
        f"bail, then the ladder), peak device memory {_peak_gib(dev)}")

    # the single-threaded oracle on this host, over the same frames
    base_enc = nf * n / 1e6 / _best_of(
        lambda: [oracle.encode(f, desc) for f in mixed], 3)
    base_dec = 2 * nf * n / 1e6 / _best_of(
        lambda: [oracle.decode(s) for s in photo_streams + mixed_streams], 3)
    log(f"baselines (oracle, one thread, this host, best of 3): encode "
        f"{base_enc:.3f} Mpx/s over {nf} mixed frames, decode "
        f"{base_dec:.3f} Mpx/s over {nf} photo + {nf} mixed streams")

    return {
        "metric": METRIC,
        "value": enc_mpxs,
        "unit": "Mpx/s",
        "vs_baseline": enc_mpxs / base_enc,
        "decode_mpxs": dec_mpxs["photo"],
        "decode_vs_baseline": dec_mpxs["photo"] / base_dec,
        "decode_mixed_mpxs": dec_mpxs["mixed"],
        "decode_mixed_vs_baseline": dec_mpxs["mixed"] / base_dec,
        "decode_adversarial_mpxs": adv_mpxs,
        "baseline_encode_mpxs": base_enc,
        "baseline_decode_mpxs": base_dec,
        "device": name,
        "power_limit_w": _power_limit_w(dev),
        "reps": reps,
    }


if __name__ == "__main__":
    sys.exit(main())
