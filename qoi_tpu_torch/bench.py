"""Benchmark + verification harness (reference L3: qoibench.c), the port's
counterpart of qoi_tpu/bench.py.

    python -m qoi_tpu_torch.bench <runs> <dir-of-pngs> [flags]
    python -m qoi_tpu_torch.bench <runs> --synthetic [small|full]

Mirrors the reference harness semantics: per-image roundtrip verification
before timing (qoibench.c:410-417), a discarded warmup run per codec
(qoibench.c:362-376), recursive *.png directory walking (qoibench.c:491),
and the same metric table: decode/encode ms, Mpixels/s, size KB, rate %
(qoibench.c:340-357). Codecs under test: the port through its facade on
`--device` (qoi-torch; default cuda, which raises without a card), the
single-core C++ oracle (qoi-cpp), and PIL PNG (png-pil, the stb/libpng
analog; it needs PIL, so skip it with --nopng where PIL is missing).
Every codec call returns host bytes or pixels, so the host clock covers
the device's work.

Flags (reference qoibench.c:297-304): --noverify --nowarmup --nopng
--noencode --nodecode --norecurse --onlytotals, plus --json for a
machine-readable summary line. --scaling sweeps the sequence-parallel
codec (parallel/) over sub-meshes of 1, 2, 4 ... ranks of a process
group: every rank runs the command, inside a group it brings up with
--coordinator HOST:PORT --num-processes N --process-id R (or one its
caller initialized), and rank 0 prints.
"""
from __future__ import annotations

import argparse
import io as _stdio
import json
import pathlib
import sys
import time
from dataclasses import dataclass
from typing import Callable, Dict, List

import numpy as np
import torch

from . import format as fmt


@dataclass
class Result:
    """Per-codec accumulated metrics (reference benchmark_result_t,
    qoibench.c:319-332)."""

    decode_ns: float = 0.0
    encode_ns: float = 0.0
    size: int = 0
    px: int = 0
    count: int = 0

    def add(self, other: "Result") -> None:
        self.decode_ns += other.decode_ns
        self.encode_ns += other.encode_ns
        self.size += other.size
        self.px += other.px
        self.count += other.count

    def row(self, raw_bytes: int) -> Dict[str, float]:
        d_ms = self.decode_ns / 1e6 / max(self.count, 1)
        e_ms = self.encode_ns / 1e6 / max(self.count, 1)
        return {
            "decode_ms": d_ms,
            "encode_ms": e_ms,
            "decode_mpps": (self.px / 1e6) / (self.decode_ns / 1e9) if self.decode_ns else 0.0,
            "encode_mpps": (self.px / 1e6) / (self.encode_ns / 1e9) if self.encode_ns else 0.0,
            "size_kb": self.size / 1024 / max(self.count, 1),
            "rate": 100.0 * self.size / raw_bytes if raw_bytes else 0.0,
        }


def _time(fn: Callable, runs: int, warmup: bool) -> float:
    """Best-of-runs wall time in ns, with an optional discarded warmup
    (reference BENCHMARK_FN, qoibench.c:364-376)."""
    if warmup:
        fn()
    best = float("inf")
    for _ in range(runs):
        t0 = time.perf_counter_ns()
        fn()
        best = min(best, time.perf_counter_ns() - t0)
    return best


def _png_codec():
    from PIL import Image

    def enc(pixels: np.ndarray) -> bytes:
        buf = _stdio.BytesIO()
        mode = "RGB" if pixels.shape[-1] == 3 else "RGBA"
        Image.fromarray(pixels, mode).save(buf, format="PNG")
        return buf.getvalue()

    def dec(data: bytes) -> np.ndarray:
        return np.asarray(Image.open(_stdio.BytesIO(data)))

    return enc, dec


def bench_image(name: str, pixels: np.ndarray, opts,
                totals: Dict[str, Result]) -> None:
    import qoi_tpu_torch

    from . import oracle

    h, w, ch = pixels.shape
    desc = fmt.StreamDesc(w, h, ch)
    n_px = w * h
    raw = n_px * ch
    dev = opts.device

    stream = oracle.encode(pixels, desc)

    # -- verification gate (reference qoibench.c:410-417)
    if not opts.noverify:
        if qoi_tpu_torch.encode(pixels, desc, device=dev) != stream:
            sys.exit(f"VERIFY: qoi-torch encode of {name} mismatches oracle")
        got, _ = qoi_tpu_torch.decode(stream, device=dev)
        if not np.array_equal(got.reshape(h, w, ch), pixels):
            sys.exit(f"VERIFY: qoi-torch decode of {name} mismatches source")

    codecs: Dict[str, Dict[str, Callable]] = {
        "qoi-torch": dict(
            encode=lambda: qoi_tpu_torch.encode(pixels, desc, device=dev),
            decode=lambda: qoi_tpu_torch.decode(stream, device=dev),
            size=len(stream),
        ),
        "qoi-cpp": dict(
            encode=lambda: oracle.encode(pixels, desc),
            decode=lambda: oracle.decode(stream),
            size=len(stream),
        ),
    }
    if not opts.nopng:
        penc, pdec = _png_codec()
        png_bytes = penc(pixels)
        codecs["png-pil"] = dict(
            encode=lambda: penc(pixels),
            decode=lambda: pdec(png_bytes),
            size=len(png_bytes),
        )

    rows: Dict[str, Result] = {}
    for cname, c in codecs.items():
        r = Result(size=c["size"], px=n_px, count=1)
        if not opts.nodecode:
            r.decode_ns = _time(c["decode"], opts.runs, not opts.nowarmup)
        if not opts.noencode:
            r.encode_ns = _time(c["encode"], opts.runs, not opts.nowarmup)
        rows[cname] = r
        totals.setdefault(cname, Result()).add(r)

    if not opts.onlytotals:
        print(f"## {name} — {w}x{h} {ch}ch")
        _print_table(rows, raw)


def _print_table(rows: Dict[str, Result], raw_bytes: int) -> None:
    """The reference's metric table (qoibench.c:340-357)."""
    hdr = f"{'':12s}{'decode ms':>12s}{'encode ms':>12s}{'decode mpps':>13s}{'encode mpps':>13s}{'size kb':>10s}{'rate':>7s}"
    print(hdr)
    for name, r in rows.items():
        m = r.row(raw_bytes)
        print(f"{name:12s}{m['decode_ms']:12.3f}{m['encode_ms']:12.3f}"
              f"{m['decode_mpps']:13.2f}{m['encode_mpps']:13.2f}"
              f"{m['size_kb']:10.0f}{m['rate']:6.1f}%")
    print()


def _walk_pngs(root: pathlib.Path, recurse: bool) -> List[pathlib.Path]:
    pat = "**/*.png" if recurse else "*.png"
    return sorted(root.glob(pat))


def synthetic_suite(kind: str = "full"):
    from .utils import testimages

    if kind == "small":
        return [
            ("64x64_rgb", testimages.mixed(64, 64, 3)),
            ("48x32_rgba", testimages.mixed(48, 32, 4)),
        ]
    return testimages.bench_suite()


#: (width, height) of the --scaling sweep's RGBA photo, the JAX sweep's
SCALING_SHAPE = (1024, 512)


def scaling_sweep(opts, shape=SCALING_SHAPE) -> int:
    """Tiled (sequence-parallel) encode and decode of one RGBA photo of
    `shape` (width, height) over sub-meshes of the first 1, 2, 4 ... ranks of the process
    group; rank 0 prints Mpx/s and scaling efficiency per shard count
    (N-shard Mpx/s over N times the 1-shard Mpx/s), the JAX sweep's
    table and JSON keys. Unless --noverify, each shard count's stream
    and pixels are checked before it is timed. Ranks that share a card
    measure the codec's path, not a multi-GPU rate, and the output says
    so."""
    import torch.distributed as dist

    from .models import pipeline
    from .parallel import sharding, tiled, tiled_decode
    from .utils import profiling, testimages

    world = dist.get_world_size()
    dev = sharding.rank_device(opts.device)
    w, h = shape
    img = testimages.photo(w, h, 4)
    desc = fmt.StreamDesc(w, h, 4)
    n_px = desc.num_pixels
    # the stream to decode, on every rank (the one-device encode's bytes)
    stream = pipeline.encode(img, desc, dev)
    enc_mpps, dec_mpps = {}, {}
    s = 1
    while s <= world:
        # every rank creates the sub-groups; the first s ranks measure
        mesh = sharding.mesh_over(range(s), 1, s, dev)
        if mesh is not None:
            if not opts.noverify:   # the gate before timing
                if tiled.encode_tiled(img, desc, mesh, dev) != stream:
                    sys.exit(f"VERIFY: tiled encode over {s} shards "
                             "mismatches the one-device stream")
                got, _ = tiled_decode.decode_tiled(stream, mesh, 0, dev)
                if not np.array_equal(got, img):
                    sys.exit(f"VERIFY: tiled decode over {s} shards "
                             "mismatches the source")
            dt = profiling.device_sync_time(
                lambda m=mesh: tiled.encode_tiled(img, desc, m, dev),
                reps=opts.runs, device=dev)
            enc_mpps[s] = n_px / 1e6 / dt
            ddt = profiling.device_sync_time(
                lambda m=mesh: tiled_decode.decode_tiled(stream, m, 0, dev),
                reps=opts.runs, device=dev)
            dec_mpps[s] = n_px / 1e6 / ddt
        s *= 2
    if dist.get_rank() != 0:
        return 0

    enc_eff = profiling.scaling_efficiency(enc_mpps)
    dec_eff = profiling.scaling_efficiency(dec_mpps)
    where = (f"{torch.cuda.device_count()} card(s), "
             f"{torch.cuda.get_device_name(dev)}" if dev.type == "cuda"
             else "the CPU")
    print(f"# scaling sweep (tiled single-stream, {w}x{h} RGBA), "
          f"{world} ranks on {where}")
    if dev.type != "cuda" or torch.cuda.device_count() < world:
        print("# the ranks share one device: these rates measure the "
              "sharded path, not a multi-device scaling")
    print("shards   encode mpps   eff     decode mpps   eff")
    for k in sorted(enc_mpps):
        print(f"{k:6d}   {enc_mpps[k]:11.2f}   {enc_eff[k]:5.2f}   "
              f"{dec_mpps[k]:11.2f}   {dec_eff[k]:5.2f}")
    if opts.json:
        print(json.dumps({
            "encode_mpps": enc_mpps, "encode_eff": enc_eff,
            "decode_mpps": dec_mpps, "decode_eff": dec_eff,
        }, default=float))
    return 0


def main(argv=None, scaling_shape=SCALING_SHAPE) -> int:
    """The harness on `argv`; `scaling_shape` is the --scaling sweep's
    (width, height)."""
    ap = argparse.ArgumentParser(
        prog="qoi-torch-bench",
        description="QOI benchmark harness (PyTorch/CUDA engine)")
    ap.add_argument("runs", type=int, help="timed runs per codec per image")
    ap.add_argument("target", nargs="?", help="directory of .png files")
    ap.add_argument("--synthetic", nargs="?", const="full",
                    choices=("small", "full"),
                    help="use the built-in synthetic suite instead of a dir")
    for flag in ("noverify", "nowarmup", "nopng", "noencode", "nodecode",
                 "norecurse", "onlytotals"):
        ap.add_argument(f"--{flag}", action="store_true")
    ap.add_argument("--json", action="store_true",
                    help="print a JSON grand-total line")
    ap.add_argument("--scaling", action="store_true",
                    help="sequence-parallel scaling sweep: encode and "
                         "decode one image tiled over 1, 2, 4 ... ranks of "
                         "a process group; Mpx/s and scaling efficiency "
                         "per shard count (ranks that share a card give no "
                         "multi-device figure)")
    ap.add_argument("--coordinator", metavar="HOST:PORT",
                    help="with --scaling: bring up a gloo process group "
                         "of --num-processes ranks, this one "
                         "--process-id")
    ap.add_argument("--num-processes", type=int, default=None)
    ap.add_argument("--process-id", type=int, default=None)
    ap.add_argument("--device", default="cuda",
                    help="torch device of qoi-torch (default: cuda)")
    opts = ap.parse_args(argv)
    if opts.runs < 1:
        ap.error("runs must be >= 1")
    from . import _device

    opts.device = _device(opts.device)
    if opts.scaling:
        import torch.distributed as dist

        if opts.coordinator:
            if opts.num_processes is None or opts.process_id is None:
                ap.error("--coordinator needs --num-processes and "
                         "--process-id")
            from .corpus import init_distributed

            init_distributed(opts.coordinator, opts.num_processes,
                             opts.process_id)
            try:
                return scaling_sweep(opts, scaling_shape)
            finally:
                dist.destroy_process_group()
        if not dist.is_initialized():
            ap.error("--scaling runs in a torch.distributed process group: "
                     "pass --coordinator, --num-processes and --process-id "
                     "to every rank")
        return scaling_sweep(opts, scaling_shape)

    images = []
    if opts.synthetic:
        images = synthetic_suite(opts.synthetic)
    elif opts.target:
        from . import io as qio

        paths = _walk_pngs(pathlib.Path(opts.target), not opts.norecurse)
        if not paths:
            ap.error(f"no .png files under {opts.target}")
        images = [(str(p), qio.load_png(p)) for p in paths]
    else:
        ap.error("need a directory or --synthetic")

    totals: Dict[str, Result] = {}
    raw_total = 0
    for name, pixels in images:
        raw_total += pixels.size
        bench_image(name, pixels, opts, totals)

    dev = opts.device
    dev_name = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                else dev.type)
    print(f"# Grand total for {len(images)} images, qoi-torch on {dev_name}")
    _print_table(totals, raw_total)

    if opts.json:
        summary = {name: r.row(raw_total) for name, r in totals.items()}
        summary["images"] = len(images)
        summary["device"] = dev_name
        print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
