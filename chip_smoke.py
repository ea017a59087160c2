#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (qoi_tpu_torch) on one GPU.

Run from the repository root on a machine with a CUDA card:

    python3 chip_smoke.py

It builds the CUDA kernels from qoi_tpu_torch/csrc/ (one nvcc per source,
in parallel), holds each of the eighteen kernels against its plain
PyTorch twin (results must be exactly equal): the six parallel ones, the
encode's word compaction (compact_words, at the 4K mixed frame's records,
also against the word-sum route of slide_val), the
word-form staging of the encode main path (encode_stage_words, at the 4K
mixed frame's bucket with the seed carry and with carries in and out,
and at the 4K RGB photo), the pack encode's byte-plane staging
(encode_stage_planes, at the same inputs), v2's reset-or-add scan
(resolve_scan, at the 4K photo and mixed streams' leaves and at a
ragged length, with the ptxas report of its kernel), the
numeric re-scan and the decode's one-pass scans in their five forms
(fsm_scan, the FSM's maps; fsm_starts, its starts and states;
initial_scan, _initial_w's maps and sums from leaves; initial_w_scan,
_initial_w from the bytes and starts; anch_scan, also at the surgical
round's (64, b) rows; torch.cumsum of an int32 plane timed beside them
as a yardstick of one pass, not the same function) at the shapes their
paths give them at 4K, the two sequential codec scans at 65,536 pixels
from a random entry state;
numeric_scan also at a 4 MiB streamed tile's shape, (8192, 512), timed, and
the ptxas report of its build (registers, shared memory, spills);
slide_val also at a sequence-parallel tile's shape (405, 40960).
decode_scan also runs on a whole 4 MiB streamed tile from its real entry
state, where its pixels must equal the source frame's and the fixpoint's
and its exit state the one those pixels imply. Then it drives ten paths
through the port's public functions, each with the launch counts set to 0
just before it and read just after:

  1. the main path: encode 4 RGBA `mixed` 4K frames (seeds 3..6) and 1
     RGB `photo` 4K frame (3 times) with qoi_tpu_torch.encode, each
     byte-identical to the C++ oracle; decode 4 `photo` and 4 `mixed`
     4K streams with decode_v3.decode_group and qoi_tpu_torch.decode
     (whose mixed streams take the surgical second round), pixel-identical
     to the sources; decode the adversarial 4K stream (INDEX reads of a
     never-written slot), which must fail the device fixpoint and match
     the oracle through the native ladder;
  2. the pack encode: pipeline.encode_device_pack on the same 4 + 1
     frames, byte-identical to the oracle (its staging the
     encode_stage_planes kernel);
  3. the fused staging: encode_stage.encode_stage_pallas, packed by
     pack.compact_bytes6_pack, on one mixed frame, byte-identical;
  4. the dense decode: decode_v3._decode_device(dense=True) on the 4
     photo and 4 mixed streams, pixel-identical to the sources;
  5. the streamed path (images above 16 Mpx): a 7680x4320 RGBA `mixed`
     and a 7680x4320 RGB `photo` frame encoded and decoded through the
     facade, byte- and pixel-identical; the 4096x4097 adversarial stream
     through the facade, whose tiles the decode_scan kernel repairs; and
     the sequential codec (models/scan_codec) at 4K on the adversarial
     stream and a mixed frame, against the oracle;
  6. the user surfaces, on the 4K frames and oracle streams above, files
     in a temporary directory: models.batch.encode_batch on the 4 mixed
     and the RGB photo frame (byte-identical) and decode_batch on the 4
     photo, 4 mixed, the adversarial and a corrupted-magic stream
     (pixel-identical, the adversarial through the ladder, the corrupted
     one an error), io.write/read with EngineConfig(verify=True), the
     converter CLI in process and as `python3 -m qoi_tpu_torch.cli` in a
     subprocess (started while the streamed inputs are prepared, so its
     interpreter and CUDA start-up overlap them), the facade with
     engine="scan" and engine="oracle", corpus.run_job over two .qoi
     streams with the oracle gate, and bench.main on the small synthetic
     suite;
  7. the cross-check engines and the ladder's rungs at 4K: the v1 decoder
     (decode_pipeline.decode) on a photo, a mixed and the adversarial
     stream, its iterations, and capped at one iteration (it then falls
     to decode_scan); the v2 decoder (decode_v2.decode) on the photo and
     mixed streams, its rounds (a stream that does not converge in 12
     goes to v1; each round's scan the resolve_scan kernel);
     decode_v3._resolve_p with apply="scan" (block_maps,
     compose, the numeric_scan kernel) against apply="vector" on the
     mixed stream's round 1, px and exit state equal, its initial w from
     the fields (_initial_w: initial_scan on the leaves) against
     _decode_core's from the bytes (initial_w_scan); and
     decode_v3._decode_ladder with the native decoder hidden by a hook of
     this script, which must reach v1 on the adversarial stream, beside
     the native decoder's time. All pixel-identical to the sources or the
     oracle;
  8. the sequence-parallel codec (qoi_tpu_torch.parallel): S = 4 ranks in
     one gloo process group, spawned processes that share cuda:0 (started
     while the streamed inputs are prepared), each running
     parallel.tiled.encode_tiled and parallel.tiled_decode.decode_tiled
     on the 7680x4320 RGBA `mixed` frame of path 5 (read from a temporary
     directory), and tiled_decode._decode_expand_device directly, whose
     `conv` must hold on every shard; every rank's stream must equal the
     oracle's and its pixels the source's; then
     parallel.dryrun.dryrun_multichip(4) on the same group, a (2, 2) mesh.
     A rank that fails or gives no answer within the pool's 300 s fails
     the script;
  9. conformance: the 303 images of qoi_tpu_torch/utils/make_corpus.py
     (179.9 Mpx: photo, photo_rgba, icons, screens, hash-collision and
     palette_alpha palettes, ~5 B/px noise, 1xN and Nx1 up to 16384, a
     16.38 Mpx member just under the streaming switch and a 17.28 Mpx one
     just over it), made with their oracle streams in a process of their
     own while paths 1-8 run: every image through the facade, its encode the
     oracle's bytes and its decode of the oracle's stream the source's
     pixels; the whole set through models.batch.encode_batch /
     decode_batch, a class a call, with the same gates; the
     hard/palette_alpha_* and hard/collide_* members decoded again with
     the native decoder hidden; then utils/fuzzcases.py's differential
     fuzz families (a)-(g) through the six decode paths and (g) through
     the five encode paths, and (f'), mutated and truncated 4K mixed and
     photo streams through the facade, the ladder without the native
     decoder and _decode_device(dense=True), and mutated 256x256 streams
     through every decode path: every answer the oracle's (a rejection
     where it rejects, its pixels where it accepts);
 10. measurement: the headline benchmark (qoi_tpu_torch.headline) in
     process at 4K with 2 frames, 1 dispatch and 1 rep, gates and timing,
     whose JSON line must hold every key; and the A/B harness
     (qoi_tpu_torch.abperf) on 2 streams, `decode --only "v3 scanapply"`
     (decode_v3._decode_device(apply="scan"): numeric_scan must launch
     there) and `decode --only "abl initial_w"`, and on 2 frames
     `encode --only wordsum20480,plainstage20480` (the main path's
     encode with the staging kernel, and with the staging in plain
     torch), each variant verified before it is timed;

and fails unless every kernel of a path was launched in that path's run.
Earlier lines report the card (name and power limit from nvidia-smi), each
phase's wall seconds, the build, each kernel's time beside its twin's, its
bound and its share of it and, for the placement, the time of one PyTorch
index_add_ computing the same words;
the per-phase times of one frame of the encode main path (its staging
and compaction on the kernel route and on the plain one), of each side
path and of the main decode (one photo and one mixed stream, every step
of _decode_core, the surgical round beside a full second round, and the
expand); the
rates, per-tile times and peak device memory of the streamed path; and
the user surfaces' rates beside the facade loop's on the same frames,
the CLI subprocess's wall seconds and the corpus summary; for path 8 the
ms of each direction on every rank, each rank's phase and collective
seconds and collectives (gloo on the CUDA tensors; none is staged through
the host), fixpoint rounds and peak device memory. The ranks' kernel
launches count with the parent's. Path 9 reports the facade's and the
batch API's encode and decode Mpx/s for each class of the corpus, the
fuzz cases of each family with the seconds of each path, and its wall
seconds; path 10 the headline's line and diagnostics and the harness's
variant lines. One JSON line lists the kernels. The last line is the
JSON result object.
Any failure raises and exits non-zero; without a CUDA device it exits 2
and prints no result.
"""
from __future__ import annotations

import contextlib
import io
import json
import multiprocessing
import pathlib
import subprocess
import sys
import tempfile
import threading
import time
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor

import numpy as np

W, H = 3840, 2160
NFRAMES = 4
#: the streamed path's frames: 8K UHD, 33.2 Mpx, above the 16 Mpx switch
W8, H8 = 7680, 4320
#: sequential scan kernels against their twins at small size: pixels
SCAN_PX = 1 << 16
#: the streamed path's tile (pixels for encode, bytes for decode)
TILE = 1 << 22
SEEDS = range(3, 3 + NFRAMES)
#: path 8: ranks of the sequence-parallel codec (sharing the one card),
#: and the seconds the parent waits for their answer to one call
SEQ_RANKS = 4
SEQ_TIMEOUT_S = 300

#: the H100 SXM data sheet at the full 700 W limit: HBM bandwidth, and the
#: float32 non-tensor peak, taken as the rate of the kernels' 32-bit
#: integer operations
PEAK_BYTES_S = 3.35e12
PEAK_OPS_S = 67e12


def log(msg: str) -> None:
    print(msg, flush=True)


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise RuntimeError(f"FAILED: {msg}")


def sync_ms(fn):
    """(result, host ms) of fn() bracketed by synchronizes."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def compare(name, got, want):
    """Exact comparison of two integer kernel outputs; returns max |err|."""
    err = int((got.long() - want.long()).abs().max()) if got.numel() else 0
    check(got.shape == want.shape and got.dtype == want.dtype and err == 0,
          f"{name}: kernel differs from its twin (max abs err {err})")
    return err


def bound(nbytes: float, ops: float):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    operations over the 32-bit rate."""
    t_bytes, t_ops = nbytes / PEAK_BYTES_S, ops / PEAK_OPS_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def seq_parallel_rank(tmp: str, width: int, height: int,
                      device: str = "cuda") -> dict:
    """One rank of path 8, run in a spawned process of the rank pool: the
    8K frame and its oracle stream from `tmp`, a warm-up on a small frame,
    then on the same (1, S) mesh the timed encode_tiled and decode_tiled
    and the sharded decode with its expansion called directly. Returns
    the stream, a digest of the pixels (rank 0 also saves them to `tmp`),
    `conv`, the times, the mesh's counters of each run, this process's
    kernel launches and its peak device memory. `device` "cpu" rehearses
    the path without a card."""
    import hashlib

    import torch
    import torch.distributed as dist

    from qoi_tpu_torch import format as fmt
    from qoi_tpu_torch.kernels import _build
    from qoi_tpu_torch.parallel import sharding, tiled, tiled_decode
    from qoi_tpu_torch.utils import testimages

    tmpd = pathlib.Path(tmp)
    frame = np.load(tmpd / "frame.npy")
    stream = (tmpd / "frame.qoi").read_bytes()
    desc = fmt.StreamDesc(width, height, 4)
    world = dist.get_world_size()
    on_card = device == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize()

    small = testimages.mixed(512, 256, 4, seed=3)
    mesh = sharding.make_mesh(1, world, device)
    tiled_decode.decode_tiled(tiled.encode_tiled(
        small, fmt.StreamDesc(512, 256, 4), mesh, device), mesh, 0, device)
    if sharding.make_mesh(1, world, device) is not mesh:
        raise RuntimeError("make_mesh made a second mesh in one group")
    _build.reset_launches()
    if on_card:
        torch.cuda.reset_peak_memory_stats()

    def timed(fn):
        """(fn(), its ms and the mesh's counters), the ranks started
        together by a barrier."""
        mesh.stats.reset()
        dist.barrier()
        t0 = time.perf_counter()
        got = fn()
        sync()
        return got, dict(ms=(time.perf_counter() - t0) * 1e3,
                         stats=mesh.stats.as_dict())

    stream_out, enc = timed(lambda: tiled.encode_tiled(frame, desc, mesh,
                                                       device))
    (img, _), dec = timed(lambda: tiled_decode.decode_tiled(stream, mesh, 0,
                                                            device))
    if dist.get_rank() == 0:
        np.save(tmpd / "px0.npy", img)
    mesh.stats.reset()
    local, clen, cap = tiled_decode.shard_bytes(stream, mesh.seq,
                                                mesh.device)
    _, conv = tiled_decode._decode_expand_device(local, clen, mesh.seq, cap)
    sync()
    return dict(encode=enc, decode=dec, stream=stream_out, conv=conv,
                px_sha=hashlib.sha256(img.tobytes()).hexdigest(),
                direct_rounds=mesh.stats.rounds,
                launches=dict(_build.launches),
                peak_gib=(torch.cuda.max_memory_allocated() / 2**30
                          if on_card else 0.0))


def corpus_inputs(tmp: str) -> list:
    """Path 9's inputs, made in a process of its own: each of the 303
    images of qoi_tpu_torch/utils/make_corpus.py to `tmp` as <k>.npy and
    its oracle stream as <k>.qoi. Returns the images' names, k in order."""
    from qoi_tpu_torch import oracle
    from qoi_tpu_torch.io import image_desc
    from qoi_tpu_torch.utils import make_corpus

    names = []
    for k, (name, make) in enumerate(make_corpus.full_specs()):
        img = make()
        np.save(pathlib.Path(tmp, f"{k}.npy"), img)
        pathlib.Path(tmp, f"{k}.qoi").write_bytes(
            oracle.encode(img, image_desc(img)))
        names.append(name)
    return names


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 2

    import qoi_tpu_torch
    from qoi_tpu_torch import format as fmt
    from qoi_tpu_torch import oracle
    from qoi_tpu_torch._bits import to_i32
    from qoi_tpu_torch.kernel_profile import cuda_ms, ptxas_of
    from qoi_tpu_torch.kernels import _build
    from qoi_tpu_torch.kernels import block_maps as kbm
    from qoi_tpu_torch.kernels import blocked_scan as kbs
    from qoi_tpu_torch.kernels import compact_words as kcw
    from qoi_tpu_torch.kernels import encode_stage as kstage
    from qoi_tpu_torch.kernels import expand as kexp
    from qoi_tpu_torch.kernels import numeric_scan as kns
    from qoi_tpu_torch.kernels import pack as kpack
    from qoi_tpu_torch.kernels import scan_codec as kscan
    from qoi_tpu_torch.kernels import slide as kslide
    from qoi_tpu_torch.models import (decode_pipeline, decode_v2, decode_v3,
                                      pipeline, scan_codec, streamed)
    from qoi_tpu_torch.io import image_desc
    from qoi_tpu_torch.ops import compact
    from qoi_tpu_torch.utils import fuzzcases as fz
    from qoi_tpu_torch.utils import testimages

    t_start = time.perf_counter()
    t_phase = [t_start]

    def phase_done(name):
        """Report the wall seconds since the previous phase ended."""
        now = time.perf_counter()
        log(f"phase {name}: {now - t_phase[0]:.1f} s wall")
        t_phase[0] = now

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
    build_log = so.with_suffix(".log").read_text().splitlines()
    for line in build_log:
        if any(k in line for k in ("Compiling entry", "registers", "spill")):
            log(f"  ptxas: {line.strip()}")
    log("numeric_scan_kernel, nvcc -Xptxas -v: " + "; ".join(
        ptxas_of(build_log, "numeric_scan_kernel")))
    phase_done("card and build")

    desc4 = fmt.StreamDesc(W, H, 4)
    desc3 = fmt.StreamDesc(W, H, 3)
    n = desc4.num_pixels
    npc = decode_pipeline.bucket_size(n)
    t0 = time.perf_counter()
    # the frames are made and encoded on host threads: numpy and the
    # oracle's C calls release the interpreter lock for most of the work
    with ThreadPoolExecutor(8) as pool:
        gen = ([pool.submit(testimages.mixed, W, H, 4, seed=k)
                for k in SEEDS]
               + [pool.submit(testimages.photo, W, H, 4, seed=k)
                  for k in SEEDS]
               + [pool.submit(testimages.photo, W, H, 3, seed=3)])
        frames = [f.result() for f in gen]
        streams = list(pool.map(
            lambda fd: oracle.encode(*fd),
            [(f, desc4) for f in frames[:-1]] + [(frames[-1], desc3)]))
    mixed, photo = frames[:NFRAMES], frames[NFRAMES:2 * NFRAMES]
    mixed_streams = streams[:NFRAMES]
    photo_streams = streams[NFRAMES:2 * NFRAMES]
    photo_rgb, photo_rgb_stream = frames[-1], streams[-1]
    log(f"inputs: {2 * NFRAMES + 1} 4K frames + oracle streams in "
        f"{time.perf_counter() - t0:.1f} s")
    phase_done("4K inputs")

    # path 9's corpus is made in a process of its own while the kernels
    # are timed and paths 1-8 run, and handed over in files: a thread of
    # this process, or one receiving ~900 MB through a pipe, would hold
    # the interpreter lock between their launches
    corpus_ctx = tempfile.TemporaryDirectory()
    corpus_pool = ProcessPoolExecutor(
        1, mp_context=multiprocessing.get_context("spawn"))
    corpus_names = corpus_pool.submit(corpus_inputs, corpus_ctx.name)

    def px4_of(frame, desc):
        px4 = np.zeros((npc, 4), np.uint8)
        px4[:n] = pipeline.force_rgba(frame, desc)
        return torch.from_numpy(px4).to(dev)

    def padded_body(stream):
        raw = np.frombuffer(stream, np.uint8)[fmt.HEADER_SIZE:]
        pad = np.zeros(decode_pipeline.bucket_size_fine(len(raw)), np.uint8)
        pad[: len(raw)] = raw
        return (torch.from_numpy(pad).to(dev),
                len(stream) - fmt.HEADER_SIZE - fmt.TRAILER_SIZE)

    def want_px(frame):
        return to_i32(torch.from_numpy(
            np.ascontiguousarray(frame).reshape(-1, 4).view(np.uint32)
            .reshape(-1).astype(np.int64)).to(dev))

    # ---- each kernel against its twin at the 4K path shapes ----------
    kernels = {}

    def row(name, source, replaces, err, ms, plain_ms, nbytes, ops,
            library_ms=None):
        bms, by = bound(nbytes, ops)
        kernels[name] = dict(
            route="cuda", source=f"qoi_tpu_torch/csrc/{source}",
            replaces=replaces, max_abs_err=err, ms=ms, plain_ms=plain_ms,
            bound_ms=bms, bound_by=by, library_ms=library_ms)
        lib = "" if library_ms is None else f", library {library_ms:.4f} ms"
        log(f"kernel {name}: equal to twin; {ms:.4f} ms vs plain "
            f"{plain_ms:.4f} ms; bound {bms:.4f} ms ({by}: "
            f"{nbytes / 1e6:.1f} MB, {ops / 1e6:.1f} M ops), "
            f"{100 * bms / ms:.1f}% of it{lib}")

    # A: the events of a 4K mixed frame, as encode_device_wordsum builds them
    ch = pipeline.encode_stage_chunks(px4_of(mixed[0], desc4), n)
    ev = compact.wordsum_events(ch.lo, ch.hi, ch.lens, 20480)
    val, aux = to_i32(ev.val), ev.aux.to(torch.int32)
    del ch, ev
    err = compare("slide_val", kslide.slide_val(val, aux),
                  kslide.slide_val_plain(val, aux))
    # the first timing of the run: ~0.2 s of launches first, so that it
    # does not read the card's clocks still rising from idle
    cuda_ms(lambda: kslide.slide_val(val, aux), 2000)
    log(f"slide_val planes {tuple(val.shape)}")
    k, width = kslide.cluster_shape(val.shape[1])
    log(f"slide_val cluster: {k} blocks a row, slices of {width} words "
        f"(sw = {val.shape[1]})")
    row("slide_val", "slide.cu", "qoi_tpu/kernels/slide.py:148", err,
        cuda_ms(lambda: kslide.slide_val(val, aux), 20),
        cuda_ms(lambda: kslide.slide_val_plain(val, aux), 3),
        12 * val.numel(), 4 * val.numel())
    del val, aux
    phase_done("slide_val vs twin")

    # A': the same frame's records through the compaction kernel, against
    # its twin and against the word-sum route it replaced (the events,
    # slide_val and the windowed add, on the card)
    ch = pipeline.encode_stage_chunks(px4_of(mixed[0], desc4), n)
    cap = npc * 6

    def wordsum_route():
        ev = compact.wordsum_events(ch.lo, ch.hi, ch.lens, 20480)
        val = kslide.slide_val(to_i32(ev.val), ev.aux.to(torch.int32))
        return compact._wordsum_assemble(val, ev.wbase, ev.total, ev.v_all,
                                         cap)

    got, tot = kcw.compact_words(ch.lo, ch.hi, ch.lens, cap)
    want, tot_w = kcw.compact_words_plain(ch.lo, ch.hi, ch.lens, cap)
    err = compare("compact_words", got, want)
    compare("compact_words against the word-sum route", got,
            wordsum_route()[0])
    check(int(tot) == int(tot_w), "compact_words: total")
    log(f"compact_words: {n} records, {int(tot)} stream bytes; the "
        f"word-sum route on the card {cuda_ms(wordsum_route, 5):.4f} ms")
    row("compact_words", "compact_words.cu",
        "qoi_tpu/ops/compact.py:152 (with qoi_tpu/kernels/slide.py:148)",
        err, cuda_ms(lambda: kcw.compact_words(ch.lo, ch.hi, ch.lens, cap),
                     20),
        cuda_ms(lambda: kcw.compact_words_plain(ch.lo, ch.hi, ch.lens, cap),
                3),
        12 * npc + cap + int(tot), 10 * int(tot))
    del ch, got, want
    phase_done("compact_words vs twin")

    def round1_planes(data, clen):
        """Pass 1's position-major (meta, d32, lit32) planes of a padded
        stream body in its first round (the initial w)."""
        m = data.shape[0]
        b = decode_v3._scan_block_len(m)
        starts, cls, r6, d32, lit32, npix = decode_v3._fields(data, clen)
        w0, _ = kbs.initial_w_scan(data, starts)
        w0 = torch.where(starts, w0, 0)
        return (decode_v3._pos_major(
                    (cls | (r6 << 9) | (w0 << 3)).to(torch.int32), m, b),
                decode_v3._pos_major(to_i32(d32), m, b),
                decode_v3._pos_major(to_i32(lit32), m, b))

    # B and C: the decode intermediates of a 4K mixed stream
    data, clen = padded_body(mixed_streams[0])
    m = data.shape[0]
    meta, d32_p, lit32_p = round1_planes(data, clen)
    got = kbm.block_maps(meta, d32_p, lit32_p)
    want, plain_ms = sync_ms(lambda: kbm.block_maps_plain(meta, d32_p,
                                                          lit32_p))
    err = max(compare(f"block_maps[{i}]", g, w_)
              for i, (g, w_) in enumerate(zip(got, want)))
    entry = to_i32(decode_v3._compose_entry_states(got[0], got[1]))
    del got, want
    nb = meta.shape[1]
    log(f"block_maps (b, nb) = {tuple(meta.shape)} (plain: one run, host "
        "clock)")
    row("block_maps", "block_maps.cu", "qoi_tpu/models/decode_v3.py:300",
        err, cuda_ms(lambda: kbm.block_maps(meta, d32_p, lit32_p), 5),
        plain_ms, 20 * meta.numel() + 8 * 65 * nb, 20 * meta.numel())
    phase_done("block_maps vs twin")

    # I: pass 3 as the numeric re-scan, on the same round-1 planes and the
    # block entry states pass 2 composes from them, at full shape
    got = kns.numeric_scan(meta, d32_p, lit32_p, entry)
    want, plain_ms = sync_ms(lambda: kns.numeric_scan_plain(
        meta, d32_p, lit32_p, entry))
    err = max(compare(f"numeric_scan[{i}]", g, w_)
              for i, (g, w_) in enumerate(zip(got, want)))
    del got, want
    log(f"numeric_scan (b, nb) = {tuple(meta.shape)}, from the 4K mixed "
        "stream's round-1 planes and block entry states, all lanes "
        "compared (plain: one run, host clock)")
    # per position 12 B read and 4 B written, the entry states read and
    # the exit state written; ~20 integer operations a position
    row("numeric_scan", "numeric_scan.cu", "qoi_tpu/models/decode_v3.py:441",
        err, cuda_ms(lambda: kns.numeric_scan(meta, d32_p, lit32_p, entry),
                     20),
        plain_ms, 16 * meta.numel() + 4 * 65 * nb + 4 * 65,
        20 * meta.numel())
    del meta, d32_p, lit32_p, entry
    # ... and at a streamed tile's shape: a 1080p mixed stream padded to
    # 4 MiB, (b, nb) = (8192, 512), its round-1 planes and entry states
    s1080 = oracle.encode(testimages.mixed(1920, 1080, 4, seed=3),
                          fmt.StreamDesc(1920, 1080, 4))
    raw = np.frombuffer(s1080, np.uint8)[fmt.HEADER_SIZE:]
    pad = np.zeros(TILE, np.uint8)
    pad[: len(raw)] = raw
    planes = round1_planes(torch.from_numpy(pad).to(dev),
                           len(raw) - fmt.TRAILER_SIZE)
    root, val, _, _ = kbm.block_maps(*planes)
    entry = to_i32(decode_v3._compose_entry_states(root, val))
    got = kns.numeric_scan(*planes, entry)
    want, plain_ms = sync_ms(lambda: kns.numeric_scan_plain(*planes, entry))
    for i, (g, w_) in enumerate(zip(got, want)):
        compare(f"numeric_scan tile[{i}]", g, w_)
    ms = cuda_ms(lambda: kns.numeric_scan(*planes, entry), 20)
    bms, by = bound(16 * planes[0].numel() + 4 * 65 * planes[0].shape[1]
                    + 4 * 65, 20 * planes[0].numel())
    log(f"numeric_scan at a streamed tile's shape (b, nb) = "
        f"{tuple(planes[0].shape)} (a 1080p mixed stream padded to 4 MiB, "
        f"all lanes compared): equal to twin; {ms:.4f} ms vs plain "
        f"{plain_ms:.4f} ms (one run, host clock); bound {bms:.4f} ms "
        f"({by})")
    del planes, root, val, entry, got, want
    phase_done("numeric_scan vs twin")

    # F, W, A: the decode's one-pass scans (kernels/blocked_scan) in their
    # five forms at the 4K mixed stream's path shapes: its padded bytes
    # (the FSM's maps, its starts and states), _initial_w's leaf and npix,
    # its bytes and starts (the form _decode_core takes), _anchored_w's
    # leaf from the round-1 px over the stream and over the surgical
    # round's (64, b) rows
    starts, leaf_w, npix32, leaf_a = decode_v3.scan_inputs(data, clen)
    # bytes: each input read once, each output written once (5, 3, 20, 18
    # and 8 B an element); operations: one combine an element (~40
    # integer operations for the FSM's five digit lookups and the initial
    # combine's ten fields, ~8 for anch), the numeric walk of the starts
    # and bytes forms counted as none beyond it
    for name, args, kern, plain, nbytes, ops, site in (
            ("fsm_scan", (data,), kbs.fsm_scan, kbs.fsm_scan_plain,
             5 * m, 40 * m, "qoi_tpu/ops/fsm.py:82"),
            ("fsm_starts", (data, clen), kbs.fsm_starts,
             kbs.fsm_starts_plain, 3 * m, 40 * m, "qoi_tpu/ops/fsm.py:82"),
            ("initial_scan", (leaf_w, npix32), kbs.initial_scan,
             kbs.initial_scan_plain, 20 * m, 40 * m,
             "qoi_tpu/models/decode_v3.py:197"),
            ("initial_w_scan", (data, starts), kbs.initial_w_scan,
             kbs.initial_w_scan_plain, 18 * m, 40 * m,
             "qoi_tpu/models/decode_v3.py:197"),
            ("anch_scan", (leaf_a,), kbs.anch_scan, kbs.anch_scan_plain,
             8 * m, 8 * m, "qoi_tpu/models/decode_v3.py:238")):
        got, want = kern(*args), plain(*args)
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        err = max(compare(f"{name}[{i}]", g, w_)
                  for i, (g, w_) in enumerate(zip(got, want)))
        del got, want
        log(f"{name} on {[tuple(getattr(a, 'shape', ())) for a in args]} "
            f"(the blocked_scan call at {site})")
        row(name, "blocked_scan.cu", f"qoi_tpu/ops/scans.py:102 via {site}",
            err, cuda_ms(lambda: kern(*args), 20),
            cuda_ms(lambda: plain(*args), 3), nbytes, ops)
    rows = leaf_a.reshape(-1, decode_v3._scan_block_len(m))[:64].contiguous()
    compare("anch_scan rows", kbs.anch_scan(rows), kbs.anch_scan_plain(rows))
    bms, _ = bound(8 * rows.numel(), 8 * rows.numel())
    log(f"anch_scan at the surgical round's rows {tuple(rows.shape)} "
        f"(qoi_tpu/models/decode_v3.py:266): equal to twin; "
        f"{cuda_ms(lambda: kbs.anch_scan(rows), 20):.4f} ms vs plain "
        f"{cuda_ms(lambda: kbs.anch_scan_plain(rows), 3):.4f} ms; bound "
        f"{bms:.4f} ms (bytes)")
    bms, _ = bound(12 * m, m)
    log(f"yardstick, not the same function: torch.cumsum of the ({m},) "
        f"int32 npix plane (int64 out), one pass of PyTorch's own scan: "
        f"{cuda_ms(lambda: torch.cumsum(npix32, 0), 20):.4f} ms; bound "
        f"{bms:.4f} ms (bytes)")
    del starts, leaf_w, npix32, leaf_a, rows
    phase_done("blocked scans vs twins")

    px, starts, _, pix_off, conv, _, _ = decode_v3._decode_core(data, clen)
    check(conv, "4K mixed stream did not converge for the expand input")
    pix_off32, px32 = pix_off.to(torch.int32), to_i32(px)
    err = compare("expand_px", kexp.expand_px(pix_off32, px32, npc),
                  kexp.expand_px_xla(pix_off32, px32, npc))
    log(f"expand_px M={m} n_px_cap={npc} (the twin's time includes its "
        "cumsum)")
    row("expand_px", "expand.cu", "qoi_tpu/kernels/expand.py:621", err,
        cuda_ms(lambda: kexp.expand_px(pix_off32, px32, npc), 20),
        cuda_ms(lambda: kexp.expand_px_xla(pix_off32, px32, npc), 5),
        8 * m + 4 * npc, 6 * m + 2 * npc)
    del pix_off32, px32
    phase_done("expand_px vs twin")

    # D: the two-plane rows _compact_chunks slides, same stream
    off_r, px_r, aux2, _, _ = decode_v3._chunk_events(starts, pix_off, px)
    del px, starts, pix_off, data
    got = kslide.slide_val2(off_r, px_r, aux2)
    want = kslide.slide_val2_plain(off_r, px_r, aux2)
    err = max(compare(f"slide_val2[{i}]", g, w_)
              for i, (g, w_) in enumerate(zip(got, want)))
    del got, want
    log(f"slide_val2 planes {tuple(off_r.shape)}")
    row("slide_val2", "slide.cu", "qoi_tpu/kernels/slide.py:118", err,
        cuda_ms(lambda: kslide.slide_val2(off_r, px_r, aux2), 20),
        cuda_ms(lambda: kslide.slide_val2_plain(off_r, px_r, aux2), 3),
        20 * off_r.numel(), 6 * off_r.numel())
    del off_r, px_r, aux2
    phase_done("slide_val2 vs twin")

    # P: the word/contribution planes of a 4K mixed frame
    chb = pipeline.encode_stage_chunks(px4_of(mixed[0], desc4), n,
                                       form="bytes")
    off_d, lo_d, hi_d, total = kpack.densify_records(chb.staging, chb.lens)
    del chb
    wp, c0, c1 = kpack._prep_planes(off_d, lo_d, hi_d, total)
    planes = (wp.to(torch.int32), to_i32(c0), to_i32(c1))
    del off_d, lo_d, hi_d, wp, c0, c1
    w_cap = npc * 6 // 4
    err = compare("place_words", kpack.place_words(*planes, w_cap),
                  kpack.place_words_plain(*planes, w_cap))
    idx = torch.cat([planes[0], planes[0] + 1]).long()
    vals = torch.cat([planes[1], planes[2]])

    def library_place():
        return torch.zeros(w_cap + 2, dtype=torch.int32,
                           device=dev).index_add_(0, idx, vals)

    compare("place_words vs index_add_",
            kpack.place_words(*planes, w_cap), library_place()[:w_cap])
    r = planes[0].numel()
    log(f"place_words R={r} w_cap={w_cap} total={int(total)} B")
    row("place_words", "pack.cu", "qoi_tpu/kernels/pack.py:179", err,
        cuda_ms(lambda: kpack.place_words(*planes, w_cap), 20),
        cuda_ms(lambda: kpack.place_words_plain(*planes, w_cap), 5),
        12 * r + 4 * w_cap, 8 * r, cuda_ms(library_place, 20))
    del planes, idx, vals
    phase_done("place_words vs twin and index_add_")

    # SW: the word-form staging, as encode_device_wordsum calls it on a 4K
    # frame in its 2^23-pixel bucket (the seed carry in, contains_last not
    # given), on the mixed RGBA and the RGB photo frame; and on the mixed
    # frame with carries in and out: a pending run, a table whose unwritten
    # entries are garbage, not the last tile
    rng = np.random.default_rng(15)
    carry_kw = dict(
        run_in=37, contains_last=False,
        table_in=(torch.from_numpy(rng.integers(0, 1 << 32, 64)).to(dev),
                  torch.from_numpy(rng.random(64) < 0.5).to(dev)))
    errs = []
    for label, frame, desc, kw in (("mixed RGBA", mixed[0], desc4, {}),
                                   ("photo RGB", photo_rgb, desc3, {}),
                                   ("mixed RGBA, carries", mixed[0], desc4,
                                    carry_kw)):
        px4 = px4_of(frame, desc)
        if kw:
            kw = dict(kw, prev_in=px4[5].clone())
        got = kstage.encode_stage_words(px4, n, **kw)
        want = kstage.encode_stage_words_plain(px4, n, **kw)
        errs += [compare(f"encode_stage_words {label} [{i}]", g, w_)
                 for i, (g, w_) in enumerate(zip(
                     (got.lo, got.hi, got.lens, *got.carry),
                     (want.lo, want.hi, want.lens, *want.carry)))]
        log(f"encode_stage_words {label}: N={npc} n_valid={n}, lo, hi, "
            "lens and the carry out equal to the twin's")
        del got, want
    px4 = px4_of(mixed[0], desc4)
    # per pixel 4 B read, 12 B written (lo, hi, lens); ~80 integer
    # operations, as the fused staging's
    row("encode_stage_words", "encode_stage.cu",
        "qoi_tpu/ops/scans.py:102 via qoi_tpu/ops/scans.py:181 and "
        "qoi_tpu/ops/table.py:216", max(errs),
        cuda_ms(lambda: kstage.encode_stage_words(px4, n), 20),
        cuda_ms(lambda: kstage.encode_stage_words_plain(px4, n), 3),
        16 * npc, 80 * npc)
    del px4
    phase_done("encode_stage_words vs twin")

    # SP: the byte-plane staging, as the pack encode's program A calls it
    # on a 4K frame in its bucket (the seed carry in), on the mixed RGBA
    # and the RGB photo frame, and on the mixed frame with the carries in
    # and out above
    errs = []
    for label, frame, desc, kw in (("mixed RGBA", mixed[0], desc4, {}),
                                   ("photo RGB", photo_rgb, desc3, {}),
                                   ("mixed RGBA, carries", mixed[0], desc4,
                                    carry_kw)):
        px4 = px4_of(frame, desc)
        if kw:
            kw = dict(kw, prev_in=px4[5].clone())
        got = kstage.encode_stage_planes(px4, n, **kw)
        want = kstage.encode_stage_planes_plain(px4, n, **kw)
        errs += [compare(f"encode_stage_planes {label} [{i}]", g, w_)
                 for i, (g, w_) in enumerate(zip(
                     (got.staging, got.lens, *got.carry),
                     (want.staging, want.lens, *want.carry)))]
        log(f"encode_stage_planes {label}: N={npc} n_valid={n}, the (6, "
            "N) planes, lens and the carry out equal to the twin's")
        del got, want
    px4 = px4_of(mixed[0], desc4)
    # per pixel 4 B read, 10 B written (six plane bytes, lens); ~80
    # integer operations, as the other staging forms'
    row("encode_stage_planes", "encode_stage.cu",
        "qoi_tpu/ops/scans.py:102 via qoi_tpu/ops/scans.py:181 and "
        "qoi_tpu/ops/table.py:216, form=\"bytes\" "
        "(qoi_tpu/models/pipeline.py:209)", max(errs),
        cuda_ms(lambda: kstage.encode_stage_planes(px4, n), 20),
        cuda_ms(lambda: kstage.encode_stage_planes_plain(px4, n), 3),
        14 * npc, 80 * npc)
    del px4
    phase_done("encode_stage_planes vs twin")

    # R: v2's reset-or-add scan on the 4K photo and mixed streams'
    # round-0 leaves, padded as decode_v2.decode pads them, and on a
    # ragged prefix of each
    errs, leaves = [], {}
    for label, stream in (("photo", photo_streams[0]),
                          ("mixed", mixed_streams[0])):
        leaves[label] = decode_v2.round0_leaves(
            *decode_v2.stream_body(stream, dev))
        mr = len(stream) - fmt.HEADER_SIZE - 12345
        for lab, (rf, vl) in ((label, leaves[label]),
                              (f"{label}, ragged M = {mr}",
                               tuple(x[:, :mr].contiguous()
                                     for x in leaves[label]))):
            errs.append(compare(f"resolve_scan {lab}",
                                kbs.resolve_scan(rf, vl),
                                kbs.resolve_scan_plain(rf, vl)))
            log(f"resolve_scan {lab}: (4, {rf.shape[1]}) equal to the twin")
    # per position 8 B read, 4 B written; ~30 integer operations (the
    # flag bits, the transposes, a fold and an apply)
    log("resolve_kernel, nvcc -Xptxas -v: " + "; ".join(
        ptxas_of(build_log, "resolve_kernel")))
    for label in ("mixed", "photo"):     # the row: the photo stream
        rf, vl = leaves.pop(label)
        mv = rf.shape[1]
        ms_k = cuda_ms(lambda: kbs.resolve_scan(rf, vl), 20)
        ms_p = cuda_ms(lambda: kbs.resolve_scan_plain(rf, vl), 3)
        if label == "mixed":
            bms, by = bound(12 * mv, 30 * mv)
            log(f"resolve_scan at the 4K mixed stream's (4, {mv}): "
                f"{ms_k:.4f} ms vs plain {ms_p:.4f} ms; bound {bms:.4f} "
                f"ms ({by}), {100 * bms / ms_k:.1f}% of it")
        else:
            log(f"resolve_scan at the 4K photo stream's (4, {mv})")
            row("resolve_scan", "blocked_scan.cu",
                "qoi_tpu/ops/scans.py:102 via "
                "qoi_tpu/models/decode_v2.py:146", max(errs), ms_k, ms_p,
                12 * mv, 30 * mv)
        del rf, vl
    phase_done("resolve_scan vs twin")

    # S: fused staging of a 4K mixed RGBA frame and a 4K RGB photo frame
    for label, frame, desc in (("mixed RGBA", mixed[0], desc4),
                               ("photo RGB", photo_rgb, desc3)):
        px4 = px4_of(frame, desc)
        got = kstage.encode_stage_pallas(px4, n)
        want = kstage.encode_stage_plain(px4, n)
        err = max(compare(f"encode_stage {label} [{i}]", g, w_)
                  for i, (g, w_) in enumerate(zip(got, want)))
        del got, want
        log(f"encode_stage {label}: N={npc} n_valid={n}")
        if label == "mixed RGBA":
            row("encode_stage", "encode_stage.cu",
                "qoi_tpu/kernels/encode_stage.py:226", err,
                cuda_ms(lambda: kstage.encode_stage_pallas(px4, n), 20),
                cuda_ms(lambda: kstage.encode_stage_plain(px4, n), 3),
                14 * npc, 80 * npc)
        del px4
    phase_done("encode_stage vs twin")

    # the CLI subprocess of path 6 starts now: its interpreter and CUDA
    # start-up overlap the host's preparation of the streamed inputs, and
    # it has ended before any later timing (the library is built)
    tmp_ctx = tempfile.TemporaryDirectory()
    tmp = pathlib.Path(tmp_ctx.name)
    (tmp / "in.qoi").write_bytes(mixed_streams[0])
    cli_sub = {}

    def run_cli_subprocess():
        t0 = time.perf_counter()
        cli_sub["res"] = subprocess.run(
            [sys.executable, "-m", "qoi_tpu_torch.cli", str(tmp / "in.qoi"),
             str(tmp / "sub.qoi"), "--verify"],
            cwd=pathlib.Path(__file__).resolve().parent, capture_output=True,
            text=True, timeout=300)
        cli_sub["s"] = time.perf_counter() - t0

    cli_thread = threading.Thread(target=run_cli_subprocess)
    cli_thread.start()

    # path 8's ranks start now too: their interpreters, CUDA contexts and
    # process group come up while the host prepares the streamed inputs
    from qoi_tpu_torch.parallel import dryrun
    from qoi_tpu_torch.parallel.launch import RankPool

    seq_pool = RankPool(SEQ_RANKS, device="cuda", timeout_s=SEQ_TIMEOUT_S)

    # the streamed path's inputs: two 8K frames and the adversarial stream
    t0 = time.perf_counter()
    desc8 = (fmt.StreamDesc(W8, H8, 4), fmt.StreamDesc(W8, H8, 3))
    with ThreadPoolExecutor(2) as pool:
        big = list(pool.map(lambda x: (x[0], x[1](), x[2]), (
            ("RGBA mixed", lambda: testimages.mixed(W8, H8, 4, seed=3),
             desc8[0]),
            ("RGB photo", lambda: testimages.photo(W8, H8, 3, seed=3),
             desc8[1]))))
        big = list(pool.map(lambda x: (*x, oracle.encode(x[1], x[2])), big))
    desc_adv = fmt.StreamDesc(4096, 4097, 4)
    adv_big = (fmt.pack_header(desc_adv) + b"\x05" * desc_adv.num_pixels
               + fmt.TRAILER)
    adv_img = oracle.decode(adv_big)[0]
    adv4 = fmt.pack_header(desc4) + b"\x05" * n + fmt.TRAILER
    adv4_img = oracle.decode(adv4)[0]
    adv4_canonical = oracle.encode(adv4_img, desc4)
    log(f"streamed inputs: 2 {W8}x{H8} frames + oracle streams, the "
        f"{desc_adv.width}x{desc_adv.height} adversarial stream, in "
        f"{time.perf_counter() - t0:.1f} s")
    # path 8 reads the RGBA mixed frame and its stream from here
    seq_ctx = tempfile.TemporaryDirectory()
    seq_dir = pathlib.Path(seq_ctx.name)
    np.save(seq_dir / "frame.npy", big[0][1])
    (seq_dir / "frame.qoi").write_bytes(big[0][3])
    phase_done("streamed inputs")

    # slide_val at the shape a rank's tile gives it in path 8: the events
    # of tile 1 of the 8K mixed frame, B = 8,294,400 px in 20480-px rows
    bt = -(-desc8[0].num_pixels // SEQ_RANKS)
    tile = torch.from_numpy(np.ascontiguousarray(
        big[0][1].reshape(-1, 4)[bt:2 * bt])).to(dev)
    ch = pipeline.encode_stage_chunks(tile, bt)
    ev = compact.wordsum_events(ch.lo, ch.hi, ch.lens, 20480)
    val, aux = to_i32(ev.val), ev.aux.to(torch.int32)
    err = compare("slide_val at the tile shape", kslide.slide_val(val, aux),
                  kslide.slide_val_plain(val, aux))
    log(f"kernel slide_val at a sequence-parallel tile's shape "
        f"{tuple(val.shape)}: equal to twin (max abs err {err})")
    del tile, ch, ev, val, aux
    phase_done("slide_val at the tile shape")

    # Q: the sequential scans. Both kernels against their twins at SCAN_PX
    # pixels from a random entry state: decode_scan on the adversarial
    # bytes (one INDEX byte a pixel, the repair path's input) and on a 4K
    # mixed stream's first bytes, encode_scan on a 4K mixed frame's first
    # SCAN_PX pixels (the twins walk in Python). Then decode_scan at the
    # streamed path's shape: tile 2 of the 8K mixed stream (4 MiB) from
    # tile 1's real exit state, held exactly to the source frame's pixels
    # of that tile and to the fixpoint's, its exit state to the one those
    # pixels imply (kernels/scan_codec.exit_state_of), and timed there.
    rng = np.random.default_rng(5)
    state = torch.from_numpy(
        rng.integers(-2**31, 2**31, 65).astype(np.int32)).to(dev)
    adv_bytes = torch.full((SCAN_PX + 8,), 5, dtype=torch.uint8, device=dev)
    mix_bytes = torch.from_numpy(np.frombuffer(mixed_streams[0], np.uint8)[
        fmt.HEADER_SIZE:fmt.HEADER_SIZE + 8 * SCAN_PX].copy()).to(dev)
    errs, small_ms = [], {}
    for label, body in (("mixed", mix_bytes), ("adversarial", adv_bytes)):
        got = kscan.decode_scan(body, SCAN_PX, body.numel(), state)
        want, t = sync_ms(lambda: kscan.decode_scan_plain(
            body.cpu(), SCAN_PX, body.numel(), state.cpu()))
        errs += [compare(f"decode_scan {label} [{i}]", g.cpu(), w_)
                 for i, (g, w_) in enumerate(zip(got, want))]
        small_ms[label] = (cuda_ms(lambda: kscan.decode_scan(
            body, SCAN_PX, body.numel(), state), 20), t)
    del adv_bytes, mix_bytes
    stream8, frame8 = big[0][3], big[0][1]
    data8 = torch.from_numpy(np.frombuffer(stream8, np.uint8)[
        fmt.HEADER_SIZE:fmt.HEADER_SIZE + 2 * TILE].copy()).to(dev)
    clen8 = len(stream8) - fmt.HEADER_SIZE - fmt.TRAILER_SIZE
    fix1, used1, entry = streamed._dec_tile_at(
        data8, 0, clen8, streamed._seed65(dev), TILE, TILE, 12, 1 << 30)
    fix2, used2, _ = streamed._dec_tile_at(data8, used1, clen8, entry, TILE,
                                           TILE, 12, 1 << 30)
    n1, n2 = fix1.numel(), fix2.numel()
    body, state = data8[used1:used1 + TILE], to_i32(entry)
    got = kscan.decode_scan(body, n2, used2, state)
    errs.append(compare("decode_scan 8K tile 2 vs the source pixels", got[0],
                        want_px(frame8)[n1:n1 + n2]))
    compare("decode_scan 8K tile 2 vs the fixpoint", got[0], fix2)
    errs.append(compare("decode_scan 8K tile 2 exit state vs its pixels'",
                        got[1], kscan.exit_state_of(got[0], state)))
    ms = cuda_ms(lambda: kscan.decode_scan(body, n2, used2, state), 10)
    log("decode_scan: " + "; ".join(
        f"{SCAN_PX} px {k} from a random entry state equal to its twin, "
        f"{v[0]:.4f} ms ({SCAN_PX / 1e3 / v[0]:.3f} Mpx/s), twin {v[1]:.1f} "
        "ms (one run, host clock)" for k, v in small_ms.items())
        + f"; tile 2 of the 8K mixed stream ({used2} B, {n2} px) from tile "
        f"1's exit state equal to the source pixels and the fixpoint, exit "
        f"state equal to its pixels'; {ms:.4f} ms, {n2 / 1e3 / ms:.3f} "
        "Mpx/s (the row's plain time: its twin on the mixed SCAN_PX)")
    # per pixel 4 bytes written, each byte read once; ~30 integer
    # operations a pixel
    row("decode_scan", "scan_codec.cu", "qoi_tpu/models/scan_codec.py:147",
        max(errs), ms, small_ms["mixed"][1], used2 + 4 * n2 + 2 * 65 * 4,
        30 * n2)
    del data8, body, got, fix1, fix2
    px32 = torch.from_numpy(np.ascontiguousarray(mixed[0]).reshape(-1, 4)[
        :SCAN_PX].view(np.int32).reshape(-1).copy()).to(dev)
    got = kscan.encode_scan(px32)
    want, plain_ms = sync_ms(lambda: kscan.encode_scan_plain(px32.cpu()))
    err = max(compare(f"encode_scan [{i}]", g.cpu(), w_)
              for i, (g, w_) in enumerate(zip(got, want)))
    ms = cuda_ms(lambda: kscan.encode_scan(px32), 20)
    px32_4k = want_px(mixed[0])
    ms_4k = cuda_ms(lambda: kscan.encode_scan(px32_4k), 5)
    log(f"encode_scan: {SCAN_PX} px of a 4K mixed frame equal to its twin; "
        f"{SCAN_PX / 1e3 / ms:.3f} Mpx/s (plain: one run, host clock); the "
        f"whole frame {ms_4k:.4f} ms, {n / 1e3 / ms_4k:.3f} Mpx/s")
    # per pixel: 4 bytes read, 6 + 4 written; ~60 integer operations
    row("encode_scan", "scan_codec.cu", "qoi_tpu/models/scan_codec.py:75",
        err, ms, plain_ms, 14 * SCAN_PX, 60 * SCAN_PX)
    del px32, px32_4k
    phase_done("sequential scans vs twins, tile and exit-state checks")

    # ---- per-phase times of one frame of each new path ----------------
    px4 = px4_of(mixed[1], desc4)
    for _ in range(2):       # the second pass is the one reported
        # the encode main path, encode_device_wordsum: its staging on the
        # kernel route, then on the plain one (int64 fields, as before the
        # kernel), each with the word-sum compaction of its fields
        ch, t_sk = sync_ms(lambda: pipeline.encode_stage_chunks(px4, n))
        _, t_ck = sync_ms(lambda: compact.compact_words6_wordsum(
            ch.lo, ch.hi, ch.lens, npc * 6, seg=20480))
        ch, t_sp = sync_ms(lambda: pipeline.stage_chunks_plain(px4, n))
        _, t_cp = sync_ms(lambda: compact.compact_words6_wordsum(
            ch.lo, ch.hi, ch.lens, npc * 6, seg=20480))
        del ch
        _, t_wd = sync_ms(lambda: pipeline.encode_device_wordsum(px4, n))
        ch, t_st = sync_ms(lambda: pipeline.encode_stage_chunks(
            px4, n, form="bytes"))
        dense, t_de = sync_ms(lambda: kpack.densify_records(ch.staging,
                                                            ch.lens))
        _, t_pl = sync_ms(lambda: kpack.place_records(*dense, npc * 6))
        del ch, dense
        st, t_fs = sync_ms(lambda: kstage.encode_stage_pallas(px4, n))
        dense, t_de2 = sync_ms(lambda: kpack.densify_records(
            st[0].T.contiguous(), st[1][:, 0]))
        _, t_pl2 = sync_ms(lambda: kpack.place_records(*dense, npc * 6))
        del st, dense
    log(f"phases, encode main path 1x4K mixed (ms): staging {t_sk:.3f}, "
        f"compaction {t_ck:.3f} (kernel route); staging {t_sp:.3f}, "
        f"compaction {t_cp:.3f} (plain route); encode_device_wordsum in "
        f"one bracket {t_wd:.3f}")
    log(f"phases, pack encode 1x4K mixed (ms): stage_chunks(bytes) "
        f"{t_st:.3f}, densify {t_de:.3f}, prep+place {t_pl:.3f}")
    log(f"phases, fused staging -> pack 1x4K mixed (ms): encode_stage "
        f"kernel {t_fs:.3f}, transpose+densify {t_de2:.3f}, prep+place "
        f"{t_pl2:.3f}")
    del px4
    for label, stream in (("photo", photo_streams[1]),
                          ("mixed", mixed_streams[1])):
        data, clen = padded_body(stream)
        for _ in range(2):
            core, t_core = sync_ms(lambda: decode_v3._decode_core(data,
                                                                  clen))
            px, starts, _, pix_off = core[:4]
            ev2, t_ev = sync_ms(lambda: decode_v3._chunk_events(
                starts, pix_off, px))
            _, t_sl = sync_ms(lambda: kslide.slide_val2(*ev2[:3]))
            dn, t_cc = sync_ms(lambda: decode_v3._compact_chunks(
                starts, pix_off, px))
            _, t_ex = sync_ms(lambda: kexp.expand_px(*dn, npc))
            del core, px, starts, pix_off, ev2, dn
        log(f"phases, dense decode 1x4K {label} (ms): _decode_core "
            f"{t_core:.3f}, _compact_chunks {t_cc:.3f} (events {t_ev:.3f}, "
            f"slide_val2 {t_sl:.3f}), expand {t_ex:.3f}")
        del data
    phase_done("side-path phases")

    # ---- per-phase times of the main decode ----------------------------
    def decode_phases(data, clen):
        """_decode_core's steps one by one, then the expand, each
        sync-bracketed (ms). Returns (phases, per-round phases, plane)."""
        m = data.shape[0]
        b = decode_v3._scan_block_len(m)
        ph = {}
        f, ph["fields+chunk_starts"] = sync_ms(
            lambda: decode_v3._fields(data, clen))
        starts, cls, r6, d32, lit32, npix = f
        (w0, pix_off), ph["initial_w"] = sync_ms(
            lambda: kbs.initial_w_scan(data, starts))
        planes, ph["planes"] = sync_ms(lambda: (
            decode_v3._pos_major((cls | (r6 << 9)).to(torch.int32), m, b),
            decode_v3._pos_major(to_i32(d32), m, b),
            decode_v3._pos_major(to_i32(lit32), m, b)))
        w = torch.where(starts, w0, 0)
        per_round = {k: [] for k in ("anchored_w", "meta", "block_maps",
                                     "compose", "apply", "certificate")}
        prev_bad, rounds, surgical = 0x7FFFFFFF, 0, None
        while True:
            meta, t = sync_ms(lambda: planes[0] | (
                decode_v3._pos_major(w, m, b) << 3).to(torch.int32))
            per_round["meta"].append(t)
            (root, val, proot, pval), t = sync_ms(
                lambda: kbm.block_maps(meta, *planes[1:]))
            per_round["block_maps"].append(t)
            entry, t = sync_ms(
                lambda: decode_v3._compose_entry_states(root, val))
            per_round["compose"].append(t)
            px, t = sync_ms(lambda: decode_v3._apply_symbolic(
                proot, pval, entry).T.reshape(m))
            per_round["apply"].append(t)

            def certificate():
                true_w = torch.where(starts, decode_v3._hash_packed(px), 0)
                return int((true_w != w).sum())

            bad, t = sync_ms(certificate)
            per_round["certificate"].append(t)
            rounds += 1
            if rounds == 1 and bad > 0 and m // b >= 256:
                # the surgical round 2 as _decode_core runs it (windows,
                # narrow rebuild, certificate), timed on its own; the
                # loop goes on with the full round 2 for its phases
                def surgical_round():
                    mis = torch.where(starts, decode_v3._hash_packed(px),
                                      0) != w
                    ids = decode_v3._surgical_windows(
                        mis.reshape(m // b, b).any(dim=1))
                    if ids is None:
                        return "windows do not cover"
                    px2, w2, _ = decode_v3._surgical_round(
                        (cls | (r6 << 9), d32, lit32), px, w, w0,
                        (root, val, entry, proot), ids, m, b)
                    bad2 = int((torch.where(
                        starts, decode_v3._hash_packed(px2), 0) != w2).sum())
                    return f"{bad2} mismatches after it"
                surgical = sync_ms(surgical_round)
            if bad > 0 and bad >= prev_bad:
                bad = -1
            if bad <= 0 or rounds >= decode_v3._MAX_ROUNDS:
                break
            prev_bad = bad
            w, t = sync_ms(lambda: torch.where(
                starts, decode_v3._anchored_w(cls, r6, d32, px), 0))
            per_round["anchored_w"].append(t)
        check(bad == 0, "phase decode did not converge")
        out, ph["expand"] = sync_ms(
            lambda: decode_v3._expand_packed(starts, px, pix_off, npc))
        return ph, per_round, surgical, out

    for label, stream, frame in (("photo", photo_streams[1], photo[1]),
                                 ("mixed", mixed_streams[1], mixed[1])):
        data, clen = padded_body(stream)
        for _ in range(2):       # the second pass is the one reported
            ph, per_round, surgical, out = decode_phases(data, clen)
            (_, _, r_s), t_all = sync_ms(
                lambda: decode_v3._decode_device(data, clen, npc))
            (_, _, r_f), t_full = sync_ms(lambda: decode_v3._decode_device(
                data, clen, npc, surgical=False))
        check(bool((out[:n] == want_px(frame)).all()),
              f"phase decode {label}: pixels differ")
        total = sum(ph.values()) + sum(sum(v) for v in per_round.values())
        rounds_txt = ", ".join(
            f"{k} " + " / ".join(f"{x:.3f}" for x in v)
            for k, v in per_round.items() if v)
        full2 = sum(v[1] for v in per_round.values() if len(v) > 1) + sum(
            per_round["anchored_w"][:1])
        surg_txt = ("" if surgical is None else
                    f"; surgical round 2 {surgical[1]:.3f} ({surgical[0]}) "
                    f"vs the full round 2 above {full2:.3f}")
        log(f"phases, main decode 1x4K {label} (ms): " + ", ".join(
            f"{k} {v:.3f}" for k, v in ph.items() if k != "expand")
            + f"; per round ({len(per_round['block_maps'])}): {rounds_txt}"
            f"{surg_txt}; expand {ph['expand']:.3f}; sum of the full rounds' "
            f"phases {total:.3f}; _decode_device in one bracket "
            f"{t_all:.3f} ({r_s} rounds), with surgical=False {t_full:.3f} "
            f"({r_f} rounds)")
        del data, out
    phase_done("main decode phases")

    # ---- the paths, each counted on its own ---------------------------
    counts_total = {k: 0 for k in _build.launches}

    def counted(label, needs, fn):
        """Run one path with the launch counts and the peak-memory counter
        reset just before it, and read both just after (a path that resets
        the counter itself returns its own peak in GiB; a path run by
        other processes returns (their peak, their summed launches), which
        count with this process's)."""
        torch.cuda.synchronize()
        _build.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        own_peak = fn() or 0.0
        torch.cuda.synchronize()
        counts = dict(_build.launches)
        if isinstance(own_peak, tuple):
            own_peak, remote = own_peak
            counts = {k: v + remote.get(k, 0) for k, v in counts.items()}
        peak = max(own_peak, torch.cuda.max_memory_allocated() / 2**30)
        log(f"launches in the {label} run: {counts}; peak device memory "
            f"{peak:.3f} GiB")
        for name in needs:
            check(counts[name] > 0,
                  f"kernel {name} never launched by the {label} run")
        for k, v in counts.items():
            counts_total[k] += v
        phase_done(f"{label} run")

    #: seconds of the main path's facade calls, for path 6's comparison
    facade_s = {"encode": 0.0, "decode": 0.0}

    def main_path():
        # encode: the RGBA mixed + 1 RGB photo (3 times, its one-frame time
        # spreads widely), byte-identical to the oracle
        ts = []
        for i, frame in enumerate(mixed):
            t0 = time.perf_counter()
            got = qoi_tpu_torch.encode(frame, device=dev)
            ts.append(time.perf_counter() - t0)
            check(got == mixed_streams[i], f"encode mixed seed {SEEDS[i]}")
        log(f"encode {NFRAMES}x4K RGBA mixed via qoi_tpu_torch.encode: "
            f"byte-identical to oracle; mean {np.mean(ts) * 1e3:.3f} "
            f"ms/frame (first {ts[0] * 1e3:.3f}, min {min(ts) * 1e3:.3f}), "
            f"{NFRAMES * n / 1e6 / sum(ts):.3f} Mpx/s")
        facade_s["encode"] += sum(ts)
        ts = []
        for _ in range(3):
            t0 = time.perf_counter()
            got = qoi_tpu_torch.encode(photo_rgb, device=dev)
            ts.append(time.perf_counter() - t0)
            check(got == photo_rgb_stream, "encode RGB photo")
        log(f"encode 1x4K RGB photo, 3 times: byte-identical to oracle; "
            f"mean {np.mean(ts) * 1e3:.3f} ms (first {ts[0] * 1e3:.3f}, "
            f"min {min(ts) * 1e3:.3f}), {3 * n / 1e6 / sum(ts):.3f} Mpx/s")
        facade_s["encode"] += float(np.mean(ts))

        # decode: decode_group (device pixels vs sources) and the facade
        for label, streams, frames in (("photo", photo_streams, photo),
                                       ("mixed", mixed_streams, mixed)):
            mcap = decode_pipeline.bucket_size_fine(
                max(len(x) for x in streams) - fmt.HEADER_SIZE)
            bodies = np.zeros((NFRAMES, mcap), np.uint8)
            clens = []
            for i, x in enumerate(streams):
                r = np.frombuffer(x, np.uint8)[fmt.HEADER_SIZE:]
                bodies[i, : len(r)] = r
                clens.append(len(x) - fmt.HEADER_SIZE - fmt.TRAILER_SIZE)
            batch = torch.from_numpy(bodies).to(dev)
            (out, conv, rounds), ms = sync_ms(
                lambda: decode_v3.decode_group(batch, clens, npc))
            check(bool(conv.all()), f"decode_group {label}: not converged")
            for i, frame in enumerate(frames):
                check(bool((out[i, :n] == want_px(frame)).all()),
                      f"decode_group {label} frame {i}: pixels differ")
            log(f"decode {NFRAMES}x4K {label} via decode_group: "
                f"pixel-identical to source; {ms / NFRAMES:.3f} ms/frame, "
                f"{NFRAMES * n / 1e3 / ms:.3f} Mpx/s; rounds per stream "
                f"{rounds.tolist()}")
            del batch, out
            ts = []
            for i, (x, frame) in enumerate(zip(streams, frames)):
                t0 = time.perf_counter()
                img, _ = qoi_tpu_torch.decode(x, device=dev)
                ts.append(time.perf_counter() - t0)
                check(np.array_equal(img, frame),
                      f"qoi_tpu_torch.decode {label} frame {i}: pixels "
                      "differ")
            facade_s["decode"] += sum(ts)
            log(f"decode {NFRAMES}x4K {label} via qoi_tpu_torch.decode: "
                f"pixel-identical; mean {np.mean(ts) * 1e3:.3f} ms/frame, "
                f"{NFRAMES * n / 1e6 / sum(ts):.3f} Mpx/s (incl. upload "
                "and pixel fetch)")

        # adversarial: must fail the device fixpoint and take the ladder
        adv = fmt.pack_header(desc4) + b"\x05" * n + fmt.TRAILER
        adata, aclen = padded_body(adv)
        _, aconv, arounds = decode_v3._decode_device(adata, aclen, npc)
        check(not aconv, "adversarial stream converged on the device")
        t0 = time.perf_counter()
        img, _ = qoi_tpu_torch.decode(adv, device=dev)
        dt = time.perf_counter() - t0
        facade_s["decode"] += dt
        check(np.array_equal(img, oracle.decode(adv)[0]),
              "adversarial decode")
        log(f"decode 1x4K adversarial: device fixpoint bailed after "
            f"{arounds} rounds, ladder result equals oracle.decode; "
            f"{dt * 1e3:.3f} ms, {n / 1e6 / dt:.3f} Mpx/s")

    def fetch_stream(desc, buf, tot):
        return (fmt.pack_header(desc)
                + buf[: int(tot)].cpu().numpy().tobytes() + fmt.TRAILER)

    def pack_path():
        ts = []
        for i, frame in enumerate(mixed):
            t0 = time.perf_counter()
            got = fetch_stream(desc4, *pipeline.encode_device_pack(
                px4_of(frame, desc4), n))
            ts.append(time.perf_counter() - t0)
            check(got == mixed_streams[i],
                  f"encode_device_pack mixed seed {SEEDS[i]}")
        log(f"encode {NFRAMES}x4K RGBA mixed via encode_device_pack: "
            f"byte-identical to oracle; mean {np.mean(ts) * 1e3:.3f} "
            f"ms/frame (min {min(ts) * 1e3:.3f}), "
            f"{NFRAMES * n / 1e6 / sum(ts):.3f} Mpx/s (incl. pad, upload "
            "and fetch)")
        t0 = time.perf_counter()
        got = fetch_stream(desc3, *pipeline.encode_device_pack(
            px4_of(photo_rgb, desc3), n))
        dt = time.perf_counter() - t0
        check(got == photo_rgb_stream, "encode_device_pack RGB photo")
        log(f"encode 1x4K RGB photo via encode_device_pack: byte-identical "
            f"to oracle; {dt * 1e3:.3f} ms")

    def staging_path():
        t0 = time.perf_counter()
        stag, lens = kstage.encode_stage_pallas(px4_of(mixed[-1], desc4), n)
        got = fetch_stream(desc4, *kpack.compact_bytes6_pack(
            stag.T.contiguous(), lens[:, 0], npc * 6))
        dt = time.perf_counter() - t0
        check(got == mixed_streams[-1], "encode_stage -> compact_bytes6_pack")
        log(f"encode 1x4K RGBA mixed via encode_stage_pallas -> "
            f"compact_bytes6_pack: byte-identical to oracle; "
            f"{dt * 1e3:.3f} ms")

    def dense_path():
        for label, streams, frames in (("photo", photo_streams, photo),
                                       ("mixed", mixed_streams, mixed)):
            ms_all, rounds = [], []
            for i, (x, frame) in enumerate(zip(streams, frames)):
                data, clen = padded_body(x)
                (out, conv, r), ms = sync_ms(
                    lambda: decode_v3._decode_device(data, clen, npc,
                                                     dense=True))
                check(conv, f"dense decode {label} frame {i}: not "
                      "converged")
                check(bool((out[:n] == want_px(frame)).all()),
                      f"dense decode {label} frame {i}: pixels differ")
                ms_all.append(ms)
                rounds.append(r)
            log(f"decode {NFRAMES}x4K {label} via _decode_device("
                f"dense=True): pixel-identical to source; mean "
                f"{np.mean(ms_all):.3f} ms/frame, "
                f"{NFRAMES * n / 1e3 / sum(ms_all):.3f} Mpx/s; rounds "
                f"{rounds}")

    peaks = []

    def timed_peak(fn):
        """(result, host seconds, peak device GiB) of fn()."""
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        peaks.append(torch.cuda.max_memory_allocated() / 2**30)
        return out, time.perf_counter() - t0, peaks[-1]

    def streamed_path():
        for label, frame, desc, stream in big:
            nb = desc.num_pixels
            dts = []
            for _ in range(2):   # the first call also pins its host tiles
                k0 = _build.launches["compact_words"]
                got, dt, peak = timed_peak(
                    lambda: qoi_tpu_torch.encode(frame, device=dev))
                tiles = _build.launches["compact_words"] - k0
                check(got == stream, f"streamed encode {label}")
                dts.append(dt)
            log(f"streamed encode {W8}x{H8} {label} via qoi_tpu_torch."
                f"encode, twice: byte-identical to oracle; {dt * 1e3:.3f} "
                f"ms (first {dts[0] * 1e3:.3f}), {nb / 1e6 / dt:.3f} Mpx/s, "
                f"{tiles} tiles, {dt * 1e3 / tiles:.3f} ms/tile, peak "
                f"{peak:.3f} GiB")
            k0 = _build.launches["expand_px"]
            (img, _), dt, peak = timed_peak(
                lambda: qoi_tpu_torch.decode(stream, device=dev))
            tiles = _build.launches["expand_px"] - k0
            check(np.array_equal(img, frame), f"streamed decode {label}")
            log(f"streamed decode {W8}x{H8} {label} ({len(stream)} B) via "
                f"qoi_tpu_torch.decode: pixel-identical; {dt * 1e3:.3f} ms, "
                f"{nb / 1e6 / dt:.3f} Mpx/s, {tiles} tiles, "
                f"{dt * 1e3 / tiles:.3f} ms/tile, peak {peak:.3f} GiB")
        nb = desc_adv.num_pixels
        k0 = _build.launches["decode_scan"]
        (img, _), dt, peak = timed_peak(
            lambda: qoi_tpu_torch.decode(adv_big, device=dev))
        check(np.array_equal(img, adv_img), "streamed adversarial decode")
        log(f"streamed decode {desc_adv.width}x{desc_adv.height} "
            f"adversarial via qoi_tpu_torch.decode: equals oracle.decode; "
            f"{_build.launches['decode_scan'] - k0} tiles repaired by "
            f"decode_scan; {dt * 1e3:.3f} ms, {nb / 1e6 / dt:.3f} Mpx/s, "
            f"peak {peak:.3f} GiB")
        # the sequential codec end to end at 4K: the adversarial stream
        # and its image, and a mixed frame and its stream
        for label, stream, frame, want in (
                ("adversarial", adv4, adv4_img, adv4_canonical),
                ("mixed", mixed_streams[0], mixed[0], mixed_streams[0])):
            (img, _), dt, _ = timed_peak(
                lambda: scan_codec.decode(stream, 0, dev))
            check(np.array_equal(img, frame),
                  f"scan_codec.decode 4K {label}")
            log(f"scan_codec.decode 4K {label} (one decode_scan launch): "
                f"equals the oracle's pixels; {dt * 1e3:.3f} ms, "
                f"{n / 1e6 / dt:.3f} Mpx/s")
            got, dt, _ = timed_peak(
                lambda: scan_codec.encode(frame, desc4, dev))
            check(got == want, f"scan_codec.encode 4K {label}")
            log(f"scan_codec.encode 4K {label} image (one encode_scan "
                f"launch): byte-identical to oracle; {dt * 1e3:.3f} ms, "
                f"{n / 1e6 / dt:.3f} Mpx/s")
        return max(peaks)

    def captured(fn):
        """(fn(), its standard output as lines) of an in-process surface,
        so that no line of it stands where the result lines go."""
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            out = fn()
        return out, buf.getvalue().splitlines()

    def surfaces_path():
        from qoi_tpu_torch import bench, cli, corpus
        from qoi_tpu_torch import io as qio
        from qoi_tpu_torch.config import EngineConfig
        from qoi_tpu_torch.models import batch

        # batched encode: the 4 mixed and the RGB photo frame in one call
        frames = mixed + [photo_rgb]
        got, ms = sync_ms(lambda: batch.encode_batch(frames, device=dev))
        for i, (g, w) in enumerate(zip(got, mixed_streams
                                       + [photo_rgb_stream])):
            check(g == w, f"encode_batch frame {i}")
        log(f"encode_batch {NFRAMES}x4K RGBA mixed + 1x4K RGB photo: "
            f"byte-identical to oracle; {ms:.3f} ms, "
            f"{(NFRAMES + 1) * n / 1e3 / ms:.3f} Mpx/s; the facade loop "
            f"on the same frames (main-path run) "
            f"{(NFRAMES + 1) * n / 1e6 / facade_s['encode']:.3f} Mpx/s")

        # batched decode: 4 photo, 4 mixed, the adversarial stream and one
        # with a corrupted magic, in one call
        bad = b"qoiX" + mixed_streams[1][4:]
        streams = photo_streams + mixed_streams + [adv4, bad]
        res, ms = sync_ms(lambda: batch.decode_batch(streams, device=dev))
        for i, frame in enumerate(photo + mixed + [adv4_img]):
            check(res[i][2] is None and np.array_equal(res[i][0], frame),
                  f"decode_batch stream {i}: pixels differ")
        check(res[-1][0] is None and "magic" in (res[-1][2] or ""),
              "decode_batch: the corrupted stream is not an error")
        nd = 2 * NFRAMES + 1
        log(f"decode_batch {NFRAMES}x4K photo + {NFRAMES}x4K mixed + the "
            f"4K adversarial + a corrupted magic: pixel-identical to the "
            f"sources (adversarial: the oracle's, through the ladder), the "
            f"corrupted stream an error ({res[-1][2]!r}); {ms:.3f} ms, "
            f"{nd * n / 1e3 / ms:.3f} Mpx/s over the {nd} frames; the "
            f"facade loop on the same {nd} streams (main-path run) "
            f"{nd * n / 1e6 / facade_s['decode']:.3f} Mpx/s")

        # io with the per-call oracle check
        cfg = EngineConfig(verify=True)
        nbytes, ms = sync_ms(lambda: qio.write(tmp / "io.qoi", mixed[1],
                                               desc4, engine=cfg, device=dev))
        check((tmp / "io.qoi").read_bytes() == mixed_streams[1],
              "io.write bytes")
        (img, _), ms2 = sync_ms(lambda: qio.read(tmp / "io.qoi", engine=cfg,
                                                 device=dev))
        check(np.array_equal(img, mixed[1]), "io.read pixels")
        log(f"io.write / io.read 1x4K mixed with verify=True: {nbytes} B, "
            f"byte- and pixel-identical; {ms:.3f} / {ms2:.3f} ms")

        # the CLI in process, then the subprocess started earlier
        (rc, out), ms = sync_ms(lambda: captured(lambda: cli.main(
            [str(tmp / "in.qoi"), str(tmp / "out.qoi"), "--verify"])))
        check(rc == 0 and (tmp / "out.qoi").read_bytes() == mixed_streams[0],
              f"cli.main rc {rc}")
        log(f"cli.main in.qoi out.qoi --verify (4K mixed): rc 0, the "
            f"oracle's bytes; {ms:.3f} ms; it printed {out}")
        cli_thread.join()
        r = cli_sub["res"]
        check(r.returncode == 0, f"CLI subprocess rc {r.returncode}: "
              f"{r.stderr[-2000:]}")
        check((tmp / "sub.qoi").read_bytes() == mixed_streams[0],
              "CLI subprocess bytes")
        log(f"python3 -m qoi_tpu_torch.cli in.qoi sub.qoi --verify (4K "
            f"mixed) in a subprocess: rc 0, the oracle's bytes; "
            f"{cli_sub['s']:.3f} s wall, start-up included; it printed "
            f"{r.stdout.strip()!r}")

        # the sequential and the host engines through the facade
        got, ms = sync_ms(lambda: qoi_tpu_torch.encode(
            mixed[2], engine="scan", device=dev))
        check(got == mixed_streams[2], "engine=scan encode")
        (img, _), ms2 = sync_ms(lambda: qoi_tpu_torch.decode(
            mixed_streams[2], engine="scan", device=dev))
        check(np.array_equal(img, mixed[2]), "engine=scan decode")
        log(f"engine=\"scan\" 1x4K mixed: byte- and pixel-identical; "
            f"encode {ms:.3f} ms, {n / 1e3 / ms:.3f} Mpx/s; decode "
            f"{ms2:.3f} ms, {n / 1e3 / ms2:.3f} Mpx/s")
        got, ms = sync_ms(lambda: qoi_tpu_torch.encode(
            mixed[3], engine="oracle", device=dev))
        check(got == mixed_streams[3], "engine=oracle encode")
        (img, _), ms2 = sync_ms(lambda: qoi_tpu_torch.decode(
            mixed_streams[3], engine="oracle", device=dev))
        check(np.array_equal(img, mixed[3]), "engine=oracle decode")
        log(f"engine=\"oracle\" 1x4K mixed: byte- and pixel-identical; "
            f"encode {ms:.3f} ms, decode {ms2:.3f} ms (host)")

        # the corpus job over two .qoi streams, gated by the oracle
        cdir = tmp / "corpus"
        cdir.mkdir()
        for i in range(2):
            (cdir / f"m{i}.qoi").write_bytes(mixed_streams[i])
        c, ms = sync_ms(lambda: corpus.run_job(
            cdir, "roundtrip", oracle_verify=True, device=dev, progress=log))
        check(c.images == 2 and c.verify_failures == 0, "corpus job")
        check((c.pixels, c.raw_bytes, c.qoi_bytes) == (
            2 * n, 2 * n * 4, len(mixed_streams[0]) + len(mixed_streams[1])),
            f"corpus counters {c}")
        log(f"corpus.run_job 2x4K mixed .qoi, roundtrip, oracle gate: "
            f"{ms:.3f} ms; summary {json.dumps(c.summary())}")

        # the harness on the small synthetic suite
        (rc, out), ms = sync_ms(lambda: captured(lambda: bench.main(
            ["1", "--synthetic", "small", "--nopng", "--onlytotals",
             "--json", "--device", "cuda"])))
        check(rc == 0, f"bench.main rc {rc}")
        for line in out:
            log(f"  bench | {line}")
        log(f"bench.main 1 --synthetic small --nopng --onlytotals --json "
            f"--device cuda: rc 0, {ms:.3f} ms")

    counted("main-path", ("encode_stage_words", "compact_words", "expand_px",
                          "block_maps", "fsm_starts", "initial_w_scan",
                          "anch_scan"), main_path)
    counted("pack-encode", ("encode_stage_planes", "place_words"),
            pack_path)
    counted("staging", ("encode_stage", "place_words"), staging_path)
    counted("dense-decode", ("slide_val2", "block_maps", "expand_px",
                             "fsm_starts", "initial_w_scan"), dense_path)
    counted("streamed", ("encode_stage_words", "compact_words", "block_maps",
                         "expand_px", "decode_scan", "encode_scan",
                         "fsm_starts", "initial_w_scan"), streamed_path)
    def cross_check_path():
        cc_peaks = []

        def peak_ms(fn):
            """(fn(), ms, peak device GiB) of one sync-bracketed call."""
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            out, ms = sync_ms(fn)
            cc_peaks.append(torch.cuda.max_memory_allocated() / 2**30)
            return out, ms, cc_peaks[-1]

        # v1: the device decode with its iterations, then the public decode
        for label, stream, want in (
                ("photo", photo_streams[0], photo[0]),
                ("mixed", mixed_streams[0], mixed[0]),
                ("adversarial", adv4, adv4_img)):
            raw = np.frombuffer(stream, np.uint8)[fmt.HEADER_SIZE:]
            pad = np.zeros(decode_pipeline.bucket_size(len(raw)), np.uint8)
            pad[: len(raw)] = raw
            data = torch.from_numpy(pad).to(dev)
            (_, conv, iters), ms_dev, peak = peak_ms(
                lambda: decode_pipeline._decode_chunks(
                    data, len(raw) - fmt.TRAILER_SIZE, npc))
            del data
            (img, _), ms = sync_ms(
                lambda: decode_pipeline.decode(stream, 0, dev))
            check(np.array_equal(img, want), f"v1 decode 4K {label}")
            log(f"v1 decode_pipeline.decode 4K {label}: pixel-identical; "
                f"{ms:.3f} ms, {n / 1e3 / ms:.3f} Mpx/s; its device decode "
                f"_decode_chunks {ms_dev:.3f} ms, peak {peak:.3f} GiB, "
                f"{iters} iterations, "
                + ("converged" if conv else "not converged: fell to "
                   "decode_scan"))
        # v1 capped at one iteration: the adversarial stream falls to the
        # sequential decoder
        k0 = _build.launches["decode_scan"]
        cap = decode_pipeline._MAX_FIXPOINT_ITERS
        decode_pipeline._MAX_FIXPOINT_ITERS = 1
        try:
            (img, _), ms = sync_ms(
                lambda: decode_pipeline.decode(adv4, 0, dev))
        finally:
            decode_pipeline._MAX_FIXPOINT_ITERS = cap
        check(np.array_equal(img, adv4_img)
              and _build.launches["decode_scan"] == k0 + 1,
              "v1 capped at one iteration: decode_scan")
        log(f"v1 capped at 1 iteration, 4K adversarial: not converged, fell "
            f"to decode_scan (1 launch), equals the oracle's pixels; "
            f"{ms:.3f} ms")
        # v2: the device decode with its rounds, then the public decode
        for label, stream, want in (("photo", photo_streams[0], photo[0]),
                                    ("mixed", mixed_streams[0], mixed[0])):
            raw = np.frombuffer(stream, np.uint8)[fmt.HEADER_SIZE:]
            pad = np.zeros(decode_pipeline.bucket_size(len(raw)), np.uint8)
            pad[: len(raw)] = raw
            data = torch.from_numpy(pad).to(dev)
            (_, conv, rounds), ms_dev, peak = peak_ms(
                lambda: decode_v2._decode_v2_device(
                    data, len(raw) - fmt.TRAILER_SIZE, npc))
            del data
            (img, _), ms = sync_ms(lambda: decode_v2.decode(stream, 0, dev))
            check(np.array_equal(img, want), f"v2 decode 4K {label}")
            log(f"v2 decode_v2.decode 4K {label}: pixel-identical; "
                f"{ms:.3f} ms, {n / 1e3 / ms:.3f} Mpx/s; its device decode "
                f"_decode_v2_device {ms_dev:.3f} ms, peak {peak:.3f} GiB, "
                f"{rounds} rounds, "
                + ("converged" if conv else "not converged (the JAX "
                   "package's cap of 12): went to v1"))
        # pass 3 both ways on the mixed stream's round 1
        data, clen = padded_body(mixed_streams[0])
        m = data.shape[0]
        b = decode_v3._scan_block_len(m)
        starts, cls, r6, d32, lit32, npix = decode_v3._fields(data, clen)
        # _initial_w's two routes: from the fields (initial_scan on the
        # leaves) and from the bytes (initial_w_scan, _decode_core's)
        w0, off0 = decode_v3._initial_w(cls, r6, d32, lit32, npix)
        w0b, off0b = kbs.initial_w_scan(data, starts)
        check(torch.equal(w0, w0b) and torch.equal(off0, off0b),
              "_initial_w from the fields differs from initial_w_scan")
        log("_initial_w on the 4K mixed stream: the leaf route "
            "(initial_scan) and the bytes route (initial_w_scan) equal")
        del w0b, off0, off0b
        w0 = torch.where(starts, w0, 0)
        planes = (decode_v3._pos_major((cls | (r6 << 9)).to(torch.int32),
                                       m, b),
                  decode_v3._pos_major(to_i32(d32), m, b),
                  decode_v3._pos_major(to_i32(lit32), m, b))
        del data, starts, cls, r6, d32, lit32, npix
        (px_s, ex_s, _), ms_s = sync_ms(lambda: decode_v3._resolve_p(
            *planes, w0, m, b, apply="scan"))
        (px_v, ex_v, _), ms_v = sync_ms(lambda: decode_v3._resolve_p(
            *planes, w0, m, b, apply="vector"))
        check(torch.equal(px_s, px_v) and torch.equal(ex_s, ex_v),
              "_resolve_p: apply=scan differs from apply=vector")
        log(f"_resolve_p 4K mixed round 1 (M = {m}, b = {b}): apply=\"scan\" "
            f"(block_maps, compose, numeric_scan) equals apply=\"vector\", "
            f"px after every byte and exit state; {ms_s:.3f} ms vs "
            f"{ms_v:.3f} ms")
        del planes, w0, px_s, px_v
        # the ladder: native, else v1 (native hidden by this hook)
        (img, _), ms_native = sync_ms(
            lambda: decode_v3._decode_ladder(adv4, 0, dev))
        check(np.array_equal(img, adv4_img), "ladder, native")
        saved = oracle.available, oracle.decode, decode_pipeline.decode
        reached = []

        def v1_hook(*a):
            reached.append(a[0])
            return saved[2](*a)

        k0 = _build.launches["decode_scan"]
        oracle.available, oracle.decode = (lambda: False), None
        decode_pipeline.decode = v1_hook
        try:
            (img, _), ms = sync_ms(
                lambda: decode_v3._decode_ladder(adv4, 0, dev))
        finally:
            oracle.available, oracle.decode, decode_pipeline.decode = saved
        check(reached == [adv4] and np.array_equal(img, adv4_img)
              and _build.launches["decode_scan"] == k0,
              "ladder without the native decoder: not v1, or not exact")
        log(f"decode_v3._decode_ladder 4K adversarial: native decoder "
            f"{ms_native:.3f} ms; with it hidden, v1 on the card "
            f"{ms:.3f} ms (converged, no decode_scan launch), both equal "
            "to the oracle's pixels")
        return max(cc_peaks)

    counted("user-surfaces", ("encode_stage_words", "compact_words",
                              "block_maps", "expand_px", "encode_scan",
                              "decode_scan"), surfaces_path)
    tmp_ctx.cleanup()
    counted("cross-check engines", ("numeric_scan", "block_maps",
                                    "decode_scan", "initial_scan",
                                    "resolve_scan"),
            cross_check_path)

    def seq_parallel_path():
        import hashlib

        label, frame, desc, stream = big[0]
        torch.cuda.empty_cache()
        res = seq_pool.run(seq_parallel_rank, str(seq_dir), W8, H8)
        src_sha = hashlib.sha256(np.ascontiguousarray(frame).tobytes()) \
            .hexdigest()
        px0 = np.load(seq_dir / "px0.npy")
        check(np.array_equal(px0, frame),
              "sequence-parallel decode, rank 0: pixels differ")
        for r, x in enumerate(res):
            check(x["stream"] == stream,
                  f"sequence-parallel encode, rank {r}: not the oracle's "
                  "bytes")
            check(x["px_sha"] == src_sha,
                  f"sequence-parallel decode, rank {r}: pixels differ")
            check(x["conv"] is True, f"rank {r}: _decode_expand_device did "
                  "not converge")
        nb = desc.num_pixels
        for d in ("encode", "decode"):
            ms = [x[d]["ms"] for x in res]
            log(f"sequence-parallel {d} {W8}x{H8} {label}, {SEQ_RANKS} ranks "
                f"on cuda:0: {'byte' if d == 'encode' else 'pixel'}-identical "
                f"on every rank; ms per rank {[round(v, 3) for v in ms]}, "
                f"slowest {max(ms):.3f} ms, {nb / 1e3 / max(ms):.3f} Mpx/s")
            for r, x in enumerate(res):
                st = x[d]["stats"]
                op, nbytes, sec = max(st["calls"], key=lambda c: c[2])
                log(f"  rank {r} {d}: phases (s) "
                    f"{ {k: round(v, 4) for k, v in st['phase_s'].items()} }"
                    f", collectives {st['collectives']} in "
                    f"{st['collective_s']:.4f} s (the longest: {op} of "
                    f"{nbytes / 1e6:.3f} MB, {sec:.4f} s)"
                    + (f", fixpoint rounds {st['rounds']}" if st['rounds']
                       else ""))
        log("sequence-parallel collectives: gloo takes the CUDA tensors "
            "(all_gather, all_reduce, reduce_scatter_tensor); staged through "
            "the host: 0")
        log(f"_decode_expand_device called directly: conv on every shard "
            f"{[x['conv'] for x in res]}, fixpoint rounds "
            f"{[x['direct_rounds'] for x in res]}; peak device memory per "
            f"rank (GiB) {[round(x['peak_gib'], 3) for x in res]}")
        t0 = time.perf_counter()
        dry = seq_pool.run(dryrun.dryrun_multichip, SEQ_RANKS)
        check(all(d == dry[0] for d in dry) and dry[0]["conv"] ==
              [True] * SEQ_RANKS, f"dryrun_multichip: {dry}")
        log(f"dryrun_multichip({SEQ_RANKS}) on the same group: mesh "
            f"{dry[0]['mesh']}, stream totals {dry[0]['totals']}, grand "
            f"total {dry[0]['grand']}, conv {dry[0]['conv']}; "
            f"{time.perf_counter() - t0:.3f} s")
        launches = {k: sum(x["launches"][k] for x in res) for k in
                    res[0]["launches"]}
        log(f"kernel launches of the {SEQ_RANKS} ranks' timed runs: "
            f"{launches}")
        return max(x["peak_gib"] for x in res), launches

    try:
        counted("sequence-parallel", ("encode_stage_words", "compact_words",
                                      "fsm_scan"), seq_parallel_path)
    finally:
        seq_pool.close()
        seq_ctx.cleanup()

    def conformance_path():
        from qoi_tpu_torch.models import batch

        t_path = time.perf_counter()
        names = corpus_names.result()
        corpus_pool.shutdown()
        cdir = pathlib.Path(corpus_ctx.name)
        items = [(name, np.load(cdir / f"{k}.npy"),
                  (cdir / f"{k}.qoi").read_bytes())
                 for k, name in enumerate(names)]
        corpus_ctx.cleanup()
        check(len(items) == 303, f"the corpus has {len(items)} images")
        log(f"conformance corpus: {len(items)} images, "
            f"{sum(im.shape[0] * im.shape[1] for _, im, _ in items) / 1e6:.3f}"
            f" Mpx, made in a process of their own during paths 1-8 (loaded "
            f"{time.perf_counter() - t_path:.1f} s after path 9 began)")
        classes = {}
        for name, img, _ in items:
            classes.setdefault(name.split("/")[0], []).append(img)

        def class_lines(label, rows):
            tot = [0, 0, 0.0, 0.0]
            for folder, (k, px, enc_s, dec_s) in rows.items():
                log(f"conformance {label} {folder}: {k} images, "
                    f"{px / 1e6:.3f} Mpx; encode {px / 1e6 / enc_s:.3f} "
                    f"Mpx/s ({enc_s:.3f} s), decode {px / 1e6 / dec_s:.3f} "
                    f"Mpx/s ({dec_s:.3f} s)")
                tot = [a + b for a, b in zip(tot, (k, px, enc_s, dec_s))]
            log(f"conformance {label} all: {tot[0]} images, "
                f"{tot[1] / 1e6:.3f} Mpx; encode {tot[1] / 1e6 / tot[2]:.3f} "
                f"Mpx/s ({tot[2]:.3f} s), decode "
                f"{tot[1] / 1e6 / tot[3]:.3f} Mpx/s ({tot[3]:.3f} s); every "
                "encode the oracle's bytes, every decode the source's pixels")

        # the facade, image by image; the 17.28 Mpx member streams
        rows = {}
        for name, img, stream in items:
            h, w, _ = img.shape
            t0 = time.perf_counter()
            got = qoi_tpu_torch.encode(img, device=dev)
            t1 = time.perf_counter()
            check(got == stream, f"conformance facade encode {name}: not "
                  "the oracle's bytes")
            out, desc = qoi_tpu_torch.decode(stream, device=dev)
            t2 = time.perf_counter()
            check(np.array_equal(out, img) and desc == image_desc(img),
                  f"conformance facade decode {name}: not the source")
            r = rows.setdefault(name.split("/")[0], [0, 0, 0.0, 0.0])
            for i, v in enumerate((1, w * h, t1 - t0, t2 - t1)):
                r[i] += v
        n_big = sum(im.shape[0] * im.shape[1] > qoi_tpu_torch
                    .STREAM_THRESHOLD_PX for _, im, _ in items)
        check(n_big == 1, f"{n_big} members above the streaming switch")
        class_lines("facade", rows)

        # the bucketed batch API, a class a call
        rows = {}
        for folder, imgs in classes.items():
            want = [s for n, _, s in items if n.startswith(folder + "/")]
            got, enc_ms = sync_ms(lambda: batch.encode_batch(imgs,
                                                             device=dev))
            bad = [i for i, (g, x) in enumerate(zip(got, want)) if g != x]
            check(not bad, f"conformance encode_batch {folder}: images "
                  f"{bad} not the oracle's bytes")
            res, dec_ms = sync_ms(lambda: batch.decode_batch(want,
                                                             device=dev))
            bad = [i for i, ((px, _, err), im) in enumerate(zip(res, imgs))
                   if err is not None or not np.array_equal(px, im)]
            check(not bad, f"conformance decode_batch {folder}: images "
                  f"{bad} not the source")
            rows[folder] = [len(imgs), sum(im.shape[0] * im.shape[1]
                                           for im in imgs),
                            enc_ms / 1e3, dec_ms / 1e3]
        class_lines("batch", rows)

        # the ladder's hard members with the native decoder hidden
        hard = [(n, im, s) for n, im, s in items
                if n.startswith(("hard/palette_alpha_", "hard/collide_"))]
        k0 = dict(_build.launches)
        t0 = time.perf_counter()
        with fz.native_hidden():
            for name, img, stream in hard:
                out, _ = qoi_tpu_torch.decode(stream, device=dev)
                check(np.array_equal(out, img),
                      f"conformance {name} without the native decoder")
        log(f"conformance without the native decoder (P2): {len(hard)} "
            f"hard/palette_alpha_* and hard/collide_* members pixel-"
            f"identical to the sources; {time.perf_counter() - t0:.3f} s; "
            f"launches { {k: v - k0[k] for k, v in _build.launches.items()} }")
        del items, classes, hard

        # the differential fuzz on the card, every family through every path
        fuzz_counts = {}
        for fam, cases in fz.families(full=True).items():
            wants = [fz.oracle_answer(c) for c in cases]
            secs = {}
            for p in fz.DECODE_PATHS:
                t0 = time.perf_counter()
                bad = fz.check_decode(p, cases, dev, wants)
                secs[p.split()[0]] = round(time.perf_counter() - t0, 3)
                check(not bad, "fuzz: " + "; ".join(bad[:5]))
            acc = sum(w is not None for w in wants)
            fuzz_counts[fam] = len(cases)
            log(f"fuzz family {fam}: {len(cases)} cases ({acc} accepted by "
                f"the oracle, {len(cases) - acc} rejected) x "
                f"{len(fz.DECODE_PATHS)} decode paths: 0 mismatches; s per "
                f"path {secs}")
        imgs = fz.encode_images(30)
        secs = {}
        for p in fz.ENCODE_PATHS:
            t0 = time.perf_counter()
            bad = fz.check_encode(p, imgs, dev)
            secs[p] = round(time.perf_counter() - t0, 3)
            check(not bad, "fuzz: " + "; ".join(bad[:5]))
        log(f"fuzz family g, encode: {len(imgs)} images x "
            f"{len(fz.ENCODE_PATHS)} encode paths: the oracle's bytes; s per "
            f"path {secs}")
        card = fz.card_cases([mixed_streams[0], photo_streams[0]])
        wants = [fz.oracle_answer(c) for c in card]
        secs = {}
        for p in fz.DECODE_PATHS[:2]:
            t0 = time.perf_counter()
            bad = fz.check_decode(p, card, dev, wants)
            secs[p.split()[0]] = round(time.perf_counter() - t0, 3)
            check(not bad, "fuzz: " + "; ".join(bad[:5]))
        t0 = time.perf_counter()
        bad, n_conv = fz.check_dense(card, dev, wants)
        secs["dense"] = round(time.perf_counter() - t0, 3)
        check(not bad, "fuzz: " + "; ".join(bad[:5]))
        log(f"fuzz family f' (4K mixed and photo, 8 mutated + 8 truncated "
            f"each): {len(card)} cases through P1, P2 and "
            f"_decode_device(dense=True): 0 mismatches, {n_conv} of "
            f"{sum(w is not None for w in wants)} converged on the dense "
            f"decode; s per path {secs}")
        small = fz.card_cases([oracle.encode(testimages.mixed(
            256, 256, 4, seed=3), fmt.StreamDesc(256, 256, 4))], n_trunc=0,
            seed=8)
        wants = [fz.oracle_answer(c) for c in small]
        for p in fz.DECODE_PATHS:
            bad = fz.check_decode(p, small, dev, wants)
            check(not bad, "fuzz: " + "; ".join(bad[:5]))
        fuzz_counts["f'"] = len(card) + len(small)
        log(f"fuzz family f' (256x256 mixed, 8 mutated): through "
            f"{len(fz.DECODE_PATHS)} decode paths: 0 mismatches; fuzz cases "
            f"by family {fuzz_counts}")
        log(f"conformance path: {time.perf_counter() - t_path:.1f} s wall")

    counted("conformance", ("encode_stage_words", "compact_words",
                            "slide_val2",
                            "expand_px", "block_maps", "place_words",
                            "encode_stage", "decode_scan", "encode_scan"),
            conformance_path)

    def measurement_path():
        from qoi_tpu_torch import abperf, headline

        t_path = time.perf_counter()

        def run(main, argv):
            """main(argv) with its stdout and stderr captured: (its
            return code, its stdout lines); stderr is logged."""
            out, err = io.StringIO(), io.StringIO()
            with contextlib.redirect_stdout(out), \
                    contextlib.redirect_stderr(err):
                rc = main(argv)
            for line in err.getvalue().splitlines():
                log(f"  {line}")
            return rc, out.getvalue().strip().splitlines()

        rc, lines = run(headline.main,
                        ["--frames", "2", "--dispatch", "1", "--reps", "1"])
        check(rc == 0 and len(lines) == 1,
              f"headline: return code {rc}, stdout {lines}")
        res = json.loads(lines[0])
        keys = ("metric", "value", "unit", "vs_baseline", "decode_mpxs",
                "decode_vs_baseline", "decode_mixed_mpxs",
                "decode_mixed_vs_baseline", "decode_adversarial_mpxs",
                *headline.EXTRA_KEYS)
        missing = [k for k in keys if k not in res]
        check(not missing and "verify_failed" not in res,
              f"headline line lacks {missing} or failed: {lines[0]}")
        log(f"headline at 4K, 2 frames, 1 dispatch, 1 rep: {lines[0]}")
        for argv, names in (
                (["decode", "--streams", "2", "--reps", "2", "--only",
                  "v3 scanapply"], ["v3 scanapply"]),
                (["decode", "--streams", "2", "--reps", "2", "--only",
                  "abl initial_w"], ["abl initial_w"]),
                (["encode", "--frames", "2", "--reps", "2", "--only",
                  "wordsum20480,plainstage20480"],
                 ["wordsum20480", "plainstage20480"])):
            k0 = _build.launches["numeric_scan"]
            rc, lines = run(abperf.main, argv)
            check(rc == 0 and [x.split(":")[0] for x in lines] == names
                  and all(" ms, median " in x for x in lines),
                  f"abperf {argv}: return code {rc}, stdout {lines}")
            for line in lines:
                log(f"abperf {argv[0]}: {line}")
            if names == ["v3 scanapply"]:
                k1 = _build.launches["numeric_scan"]
                check(k1 - k0 >= 2, "abperf v3 scanapply: numeric_scan "
                      f"launched {k1 - k0} times by _decode_device"
                      "(apply='scan') on 2 streams")
                log(f"numeric_scan launches through _decode_device("
                    f"apply=\"scan\"): {k1 - k0}")
        log(f"measurement path: {time.perf_counter() - t_path:.1f} s wall")

    counted("measurement", ("encode_stage_words", "numeric_scan",
                            "compact_words", "block_maps", "expand_px"),
            measurement_path)
    log(f"launches over the ten counted runs: {counts_total}")
    for name in kernels:
        # slide_val, the Pallas slide's counterpart, is off every path
        # since the encode's compaction runs compact_words
        check(counts_total[name] > 0 or name == "slide_val",
              f"kernel {name} never launched")
        kernels[name]["launches"] = counts_total[name]

    log(f"smoke total: {time.perf_counter() - t_start:.1f} s wall (the "
        "interpreter's start and imports before it not included)")
    log("card (nvidia-smi name, power.limit):")
    log(smi.splitlines()[0])
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    log(json.dumps({"kernels": [
        {k: ({"name": name} | v)[k] for k in keys}
        for name, v in kernels.items()]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
