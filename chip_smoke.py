#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (qoi_tpu_torch) on one GPU.

Run from the repository root on a machine with a CUDA card:

    python3 chip_smoke.py

It builds the CUDA kernels from qoi_tpu_torch/csrc/ (one nvcc per source,
in parallel), holds each of the eight kernels against its plain PyTorch
twin (results must be exactly equal): the six parallel ones at the
shapes their paths give them at 4K, the two sequential scans at 65,536
pixels from a random entry state, and decode_scan also on a whole 4 MiB
streamed tile from its real entry state. Then it drives five paths through the port's public functions,
each with the launch counts set to 0 just before it and read just after:

  1. the main path: encode 4 RGBA `mixed` 4K frames (seeds 3..6) and 1
     RGB `photo` 4K frame (3 times) with qoi_tpu_torch.encode, each
     byte-identical to the C++ oracle; decode 4 `photo` and 4 `mixed`
     4K streams with decode_v3.decode_group and qoi_tpu_torch.decode
     (whose mixed streams take the surgical second round), pixel-identical
     to the sources; decode the adversarial 4K stream (INDEX reads of a
     never-written slot), which must fail the device fixpoint and match
     the oracle through the native ladder;
  2. the pack encode: pipeline.encode_device_pack on the same 4 + 1
     frames, byte-identical to the oracle;
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

and fails unless every kernel of a path was launched in that path's run.
Earlier lines report the card (name and power limit from nvidia-smi), the
build, each kernel's time beside its twin's, its bound and, for the
placement, the time of one PyTorch index_add_ computing the same words;
the per-phase times of one frame of each side path and of the main
decode (one photo and one mixed stream, every step of _decode_core, the
surgical round beside a full second round, and the expand); and the
rates, per-tile times and peak device memory of the streamed path. One
JSON line lists the kernels. The last line is the JSON result object.
Any failure raises and exits non-zero; without a CUDA device it exits 2
and prints no result.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time

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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 2

    import qoi_tpu_torch
    from qoi_tpu_torch import format as fmt
    from qoi_tpu_torch import oracle
    from qoi_tpu_torch._bits import to_i32
    from qoi_tpu_torch.kernel_profile import cuda_ms
    from qoi_tpu_torch.kernels import _build
    from qoi_tpu_torch.kernels import block_maps as kbm
    from qoi_tpu_torch.kernels import encode_stage as kstage
    from qoi_tpu_torch.kernels import expand as kexp
    from qoi_tpu_torch.kernels import pack as kpack
    from qoi_tpu_torch.kernels import scan_codec as kscan
    from qoi_tpu_torch.kernels import slide as kslide
    from qoi_tpu_torch.models import (buckets, decode_v3, pipeline,
                                      scan_codec, streamed)
    from qoi_tpu_torch.ops import compact
    from qoi_tpu_torch.utils import testimages

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
        if any(k in line for k in ("Compiling entry", "registers", "spill")):
            log(f"  ptxas: {line.strip()}")

    desc4 = fmt.StreamDesc(W, H, 4)
    desc3 = fmt.StreamDesc(W, H, 3)
    n = desc4.num_pixels
    npc = buckets.bucket_size(n)
    t0 = time.perf_counter()
    mixed = [testimages.mixed(W, H, 4, seed=s) for s in SEEDS]
    photo = [testimages.photo(W, H, 4, seed=s) for s in SEEDS]
    photo_rgb = testimages.photo(W, H, 3, seed=3)
    mixed_streams = [oracle.encode(f, desc4) for f in mixed]
    photo_streams = [oracle.encode(f, desc4) for f in photo]
    photo_rgb_stream = oracle.encode(photo_rgb, desc3)
    log(f"inputs: {2 * NFRAMES + 1} 4K frames + oracle streams in "
        f"{time.perf_counter() - t0:.1f} s")

    def px4_of(frame, desc):
        px4 = np.zeros((npc, 4), np.uint8)
        px4[:n] = pipeline.force_rgba(frame, desc)
        return torch.from_numpy(px4).to(dev)

    def padded_body(stream):
        raw = np.frombuffer(stream, np.uint8)[fmt.HEADER_SIZE:]
        pad = np.zeros(buckets.bucket_size_fine(len(raw)), np.uint8)
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
            f"{nbytes / 1e6:.1f} MB, {ops / 1e6:.1f} M ops){lib}")

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

    # B and C: the decode intermediates of a 4K mixed stream
    data, clen = padded_body(mixed_streams[0])
    m = data.shape[0]
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
    want, plain_ms = sync_ms(lambda: kbm.block_maps_plain(meta, d32_p,
                                                          lit32_p))
    err = max(compare(f"block_maps[{i}]", g, w_)
              for i, (g, w_) in enumerate(zip(got, want)))
    del got, want
    nb = meta.shape[1]
    log(f"block_maps (b, nb) = {tuple(meta.shape)} (plain: one run, host "
        "clock)")
    row("block_maps", "block_maps.cu", "qoi_tpu/models/decode_v3.py:300",
        err, cuda_ms(lambda: kbm.block_maps(meta, d32_p, lit32_p), 5),
        plain_ms, 20 * meta.numel() + 8 * 65 * nb, 20 * meta.numel())
    del meta, d32_p, lit32_p

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

    # the streamed path's inputs: two 8K frames and the adversarial stream
    t0 = time.perf_counter()
    desc8 = (fmt.StreamDesc(W8, H8, 4), fmt.StreamDesc(W8, H8, 3))
    big = [("RGBA mixed", testimages.mixed(W8, H8, 4, seed=3), desc8[0]),
           ("RGB photo", testimages.photo(W8, H8, 3, seed=3), desc8[1])]
    big = [(label, frame, desc, oracle.encode(frame, desc))
           for label, frame, desc in big]
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


    # Q: the sequential scans. decode_scan at SCAN_PX pixels from a random
    # entry state, on the adversarial bytes (one INDEX byte a pixel, the
    # repair path's input) and on a 4K mixed stream's first bytes; then at
    # the streamed path's shape: the second 4 MiB tile of the 8K mixed
    # stream from its real entry state (the first tile's exit), held
    # against its twin and the fixpoint's pixels of that tile, and timed.
    # encode_scan on a 4K mixed frame's first SCAN_PX pixels (the twins
    # walk in Python; scan_codec.encode runs it at 4K, held to the oracle).
    rng = np.random.default_rng(5)
    state = torch.from_numpy(
        rng.integers(-2**31, 2**31, 65).astype(np.int32)).to(dev)
    adv_bytes = torch.full((SCAN_PX + 8,), 5, dtype=torch.uint8, device=dev)
    mix_bytes = torch.from_numpy(np.frombuffer(mixed_streams[0], np.uint8)[
        fmt.HEADER_SIZE:fmt.HEADER_SIZE + 8 * SCAN_PX].copy()).to(dev)
    errs = []
    for label, body in (("mixed", mix_bytes), ("adversarial", adv_bytes)):
        got = kscan.decode_scan(body, SCAN_PX, body.numel(), state)
        want = kscan.decode_scan_plain(body.cpu(), SCAN_PX, body.numel(),
                                       state.cpu())
        errs += [compare(f"decode_scan {label} [{i}]", g.cpu(), w_)
                 for i, (g, w_) in enumerate(zip(got, want))]
    del adv_bytes, mix_bytes
    stream8 = big[0][3]
    data8 = torch.from_numpy(np.frombuffer(stream8, np.uint8)[
        fmt.HEADER_SIZE:fmt.HEADER_SIZE + 2 * TILE].copy()).to(dev)
    clen8 = len(stream8) - fmt.HEADER_SIZE - fmt.TRAILER_SIZE
    _, used1, entry = streamed._dec_tile_at(
        data8, 0, clen8, streamed._seed65(dev), TILE, TILE, 12, 1 << 30)
    fix2, used2, _ = streamed._dec_tile_at(data8, used1, clen8, entry, TILE,
                                           TILE, 12, 1 << 30)
    body, state, n2 = data8[used1:used1 + TILE], to_i32(entry), fix2.numel()
    got = kscan.decode_scan(body, n2, used2, state)
    want, plain_ms = sync_ms(lambda: kscan.decode_scan_plain(
        body.cpu(), n2, used2, state.cpu()))
    errs += [compare(f"decode_scan 8K tile 2 [{i}]", g.cpu(), w_)
             for i, (g, w_) in enumerate(zip(got, want))]
    compare("decode_scan 8K tile 2 vs the fixpoint", got[0], fix2)
    ms = cuda_ms(lambda: kscan.decode_scan(body, n2, used2, state), 3)
    log(f"decode_scan: {SCAN_PX} px from a random entry state (adversarial "
        f"and mixed), and tile 2 of the 8K mixed stream ({used2} B, {n2} "
        f"px) from tile 1's exit state, equal to its twin and to the "
        f"fixpoint; tile {n2 / 1e3 / ms:.3f} Mpx/s (plain: one run, host "
        "clock)")
    # per pixel 4 bytes written, each byte read once; ~30 integer
    # operations a step
    row("decode_scan", "scan_codec.cu", "qoi_tpu/models/scan_codec.py:147",
        max(errs), ms, plain_ms, used2 + 4 * n2 + 2 * 65 * 4, 30 * n2)
    del data8, body, got, want, fix2
    px32 = torch.from_numpy(np.ascontiguousarray(mixed[0]).reshape(-1, 4)[
        :SCAN_PX].view(np.int32).reshape(-1).copy()).to(dev)
    got = kscan.encode_scan(px32)
    want, plain_ms = sync_ms(lambda: kscan.encode_scan_plain(px32.cpu()))
    err = max(compare(f"encode_scan [{i}]", g.cpu(), w_)
              for i, (g, w_) in enumerate(zip(got, want)))
    ms = cuda_ms(lambda: kscan.encode_scan(px32), 5)
    log(f"encode_scan: {SCAN_PX} px of a 4K mixed frame; "
        f"{SCAN_PX / 1e3 / ms:.3f} Mpx/s (plain: one run, host clock)")
    # per pixel: 4 bytes read, 6 + 4 written; ~60 integer operations
    row("encode_scan", "scan_codec.cu", "qoi_tpu/models/scan_codec.py:75",
        err, ms, plain_ms, 14 * SCAN_PX, 60 * SCAN_PX)
    del px32

    # ---- per-phase times of one frame of each new path ----------------
    px4 = px4_of(mixed[1], desc4)
    for _ in range(2):       # the second pass is the one reported
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
            lambda: decode_v3._initial_w(cls, r6, d32, lit32, npix))
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

    # ---- the paths, each counted on its own ---------------------------
    counts_total = {k: 0 for k in _build.launches}

    def counted(label, needs, fn):
        """Run one path with the launch counts and the peak-memory counter
        reset just before it, and read both just after (a path that resets
        the counter itself returns its own peak in GiB)."""
        torch.cuda.synchronize()
        _build.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        own_peak = fn() or 0.0
        torch.cuda.synchronize()
        counts = dict(_build.launches)
        peak = max(own_peak, torch.cuda.max_memory_allocated() / 2**30)
        log(f"launches in the {label} run: {counts}; peak device memory "
            f"{peak:.3f} GiB")
        for name in needs:
            check(counts[name] > 0,
                  f"kernel {name} never launched by the {label} run")
        for k, v in counts.items():
            counts_total[k] += v

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
        ts = []
        for _ in range(3):
            t0 = time.perf_counter()
            got = qoi_tpu_torch.encode(photo_rgb, device=dev)
            ts.append(time.perf_counter() - t0)
            check(got == photo_rgb_stream, "encode RGB photo")
        log(f"encode 1x4K RGB photo, 3 times: byte-identical to oracle; "
            f"mean {np.mean(ts) * 1e3:.3f} ms (first {ts[0] * 1e3:.3f}, "
            f"min {min(ts) * 1e3:.3f}), {3 * n / 1e6 / sum(ts):.3f} Mpx/s")

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
                k0 = _build.launches["slide_val"]
                got, dt, peak = timed_peak(
                    lambda: qoi_tpu_torch.encode(frame, device=dev))
                tiles = _build.launches["slide_val"] - k0
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

    counted("main-path", ("slide_val", "expand_px", "block_maps"), main_path)
    counted("pack-encode", ("place_words",), pack_path)
    counted("staging", ("encode_stage", "place_words"), staging_path)
    counted("dense-decode", ("slide_val2", "block_maps", "expand_px"),
            dense_path)
    counted("streamed", ("slide_val", "block_maps", "expand_px",
                         "decode_scan"), streamed_path)
    log(f"launches over the five counted runs: {counts_total}")
    for name in kernels:
        check(counts_total[name] > 0, f"kernel {name} never launched")
        kernels[name]["launches"] = counts_total[name]

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
