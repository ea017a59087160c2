"""Streaming corpus jobs with checkpoint/resume (port of qoi_tpu/corpus.py).

Processes a directory of images (the qoi_benchmark_suite layout: PNGs,
possibly nested, and .qoi streams) through encode / decode / roundtrip on
`device`, aggregating the reference harness's grand-total metrics
(qoibench.c:559-562). The corpus is sharded across processes by file
index; counters are summed at the end with one torch.distributed
all_reduce when a process group is up, else single-process.

Checkpoint/resume: the resumable state is the work-queue cursor plus the
aggregate counters, written as JSON every `checkpoint_every` images, in
the same schema as qoi_tpu/corpus.py, so a checkpoint written by either
package resumes in the other. Restarting with the same arguments picks
up where the job stopped.

    python -m qoi_tpu_torch.corpus <dir> --mode roundtrip \\
        --checkpoint job.json --shard 0 --num-shards 4 [--device cuda]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import sys
import time
from typing import List, Optional

import numpy as np


@dataclasses.dataclass
class Counters:
    images: int = 0
    pixels: int = 0
    raw_bytes: int = 0
    qoi_bytes: int = 0
    encode_ns: float = 0.0
    decode_ns: float = 0.0
    verify_failures: int = 0

    def to_json(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_json(cls, d: dict) -> "Counters":
        return cls(**d)

    def summary(self) -> dict:
        enc_s = self.encode_ns / 1e9
        dec_s = self.decode_ns / 1e9
        return {
            "images": self.images,
            "mpixels": self.pixels / 1e6,
            "encode_mpps": (self.pixels / 1e6) / enc_s if enc_s else 0.0,
            "decode_mpps": (self.pixels / 1e6) / dec_s if dec_s else 0.0,
            "rate": self.qoi_bytes / self.raw_bytes if self.raw_bytes else 0.0,
            "verify_failures": self.verify_failures,
        }


@dataclasses.dataclass
class Checkpoint:
    cursor: int
    counters: Counters
    shard: int
    num_shards: int

    def save(self, path) -> None:
        tmp = pathlib.Path(str(path) + ".tmp")
        tmp.write_text(json.dumps({
            "cursor": self.cursor,
            "counters": self.counters.to_json(),
            "shard": self.shard,
            "num_shards": self.num_shards,
        }))
        tmp.replace(path)

    @classmethod
    def load(cls, path) -> Optional["Checkpoint"]:
        p = pathlib.Path(path)
        if not p.exists():
            return None
        d = json.loads(p.read_text())
        return cls(d["cursor"], Counters.from_json(d["counters"]),
                   d["shard"], d["num_shards"])


def shard_files(root: pathlib.Path, shard: int,
                num_shards: int) -> List[pathlib.Path]:
    files = sorted(root.glob("**/*.png")) + sorted(root.glob("**/*.qoi"))
    return files[shard::num_shards]


def run_job(
    root,
    mode: str = "roundtrip",
    checkpoint_path=None,
    checkpoint_every: int = 50,
    shard: int = 0,
    num_shards: int = 1,
    verify: bool = True,
    oracle_verify: bool = False,
    progress=lambda msg: print(msg, file=sys.stderr),
    device="cuda",
) -> Counters:
    """Run (or resume) a corpus job over this shard's files on `device`.

    `verify` checks the decode roundtrip pixel-exactly; `oracle_verify`
    additionally checks every encoded stream byte-identical to the C++
    oracle (the conformance-suite trust anchor, reference qoi.h:356).
    Encode and decode go through the facade (qoi_tpu_torch.encode/
    decode), where the JAX job calls its pipeline and decode_v3 directly:
    the facade is the port's one entry that takes every image size (it
    streams above STREAM_THRESHOLD_PX). Bytes and pixels are the same
    either way."""
    import qoi_tpu_torch

    from . import _device, format as fmt, io as qio
    if oracle_verify:
        from . import oracle

    dev = _device(device)
    files = shard_files(pathlib.Path(root), shard, num_shards)
    ck = Checkpoint.load(checkpoint_path) if checkpoint_path else None
    if ck is not None and (ck.shard, ck.num_shards) != (shard, num_shards):
        raise ValueError(
            f"checkpoint is for shard {ck.shard}/{ck.num_shards}, "
            f"job is {shard}/{num_shards}")
    cursor = ck.cursor if ck else 0
    counters = ck.counters if ck else Counters()

    for i in range(cursor, len(files)):
        f = files[i]
        if f.suffix == ".png":
            pixels = qio.load_png(f)
        else:
            pixels, _ = qio.read(f, device=dev)
        h, w, ch = pixels.shape
        desc = fmt.StreamDesc(w, h, ch)

        t0 = time.perf_counter_ns()
        stream = qoi_tpu_torch.encode(pixels, desc, device=dev)
        counters.encode_ns += time.perf_counter_ns() - t0
        if oracle_verify and stream != oracle.encode(pixels, desc):
            counters.verify_failures += 1
            progress(f"ORACLE ENCODE MISMATCH: {f}")

        if mode in ("roundtrip", "decode"):
            t0 = time.perf_counter_ns()
            out, _ = qoi_tpu_torch.decode(stream, device=dev)
            counters.decode_ns += time.perf_counter_ns() - t0
            if verify and not np.array_equal(out, pixels):
                counters.verify_failures += 1
                progress(f"VERIFY FAILED: {f}")

        counters.images += 1
        counters.pixels += w * h
        counters.raw_bytes += pixels.size
        counters.qoi_bytes += len(stream)

        if checkpoint_path and (i + 1) % checkpoint_every == 0:
            Checkpoint(i + 1, counters, shard, num_shards).save(checkpoint_path)
            progress(f"checkpoint @ {i + 1}/{len(files)}")

    if checkpoint_path:
        Checkpoint(len(files), counters, shard, num_shards).save(checkpoint_path)
    return counters


def init_distributed(coordinator: str, num_processes: int,
                     process_id: int) -> None:
    """Bring up a gloo process group across `num_processes` processes;
    `coordinator` is the HOST:PORT rank 0 listens on (tcp init). The
    counters' one all_reduce runs on the CPU, whatever device the codec
    uses."""
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"tcp://{coordinator}",
                            world_size=num_processes, rank=process_id)


def allreduce_counters(counters: Counters) -> Counters:
    """Sum counters across processes when a torch.distributed process
    group is up; identity in a single process. One all_reduce of an
    int64 tensor sums the seven fields exactly (the ns timers as whole
    nanoseconds, as the JAX package does)."""
    import torch
    import torch.distributed as dist

    if not dist.is_initialized() or dist.get_world_size() == 1:
        return counters
    raw = torch.tensor([
        counters.images, counters.pixels, counters.raw_bytes,
        counters.qoi_bytes, int(counters.encode_ns), int(counters.decode_ns),
        counters.verify_failures], dtype=torch.int64)
    dist.all_reduce(raw, op=dist.ReduceOp.SUM)
    t = raw.tolist()
    return Counters(*t[:4], float(t[4]), float(t[5]), t[6])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="qoi-torch-corpus")
    ap.add_argument("root")
    ap.add_argument("--mode", choices=("encode", "decode", "roundtrip"),
                    default="roundtrip")
    ap.add_argument("--checkpoint")
    ap.add_argument("--checkpoint-every", type=int, default=50)
    ap.add_argument("--shard", type=int, default=None)
    ap.add_argument("--num-shards", type=int, default=None)
    ap.add_argument("--noverify", action="store_true")
    ap.add_argument("--oracle-verify", action="store_true",
                    help="also check every stream byte-identical to the "
                         "C++ oracle encoder")
    ap.add_argument("--coordinator", metavar="HOST:PORT",
                    help="bring up a gloo process group across processes; "
                         "shard/num-shards default to rank/world size")
    ap.add_argument("--num-processes", type=int, default=None)
    ap.add_argument("--process-id", type=int, default=None)
    ap.add_argument("--device", default="cuda",
                    help="torch device of the codec (default: cuda)")
    args = ap.parse_args(argv)
    if args.coordinator and (args.num_processes is None
                             or args.process_id is None):
        ap.error("--coordinator needs --num-processes and --process-id")

    shard, num_shards = args.shard or 0, args.num_shards or 1
    if args.coordinator:
        import torch.distributed as dist

        init_distributed(args.coordinator, args.num_processes,
                         args.process_id)
        if args.shard is None:
            shard, num_shards = dist.get_rank(), dist.get_world_size()
    try:
        counters = run_job(
            args.root, args.mode, args.checkpoint, args.checkpoint_every,
            shard, num_shards, not args.noverify,
            oracle_verify=args.oracle_verify, device=args.device)
        total = allreduce_counters(counters)
    finally:
        if args.coordinator:
            dist.destroy_process_group()
    print(json.dumps(total.summary()))
    return 1 if total.verify_failures else 0


if __name__ == "__main__":
    sys.exit(main())
