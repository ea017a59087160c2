#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (qoi_tpu_torch) on one GPU.

Run from the repository root on a machine with a CUDA card:

    python3 chip_smoke.py

It builds the CUDA kernels from qoi_tpu_torch/csrc/ (one nvcc per source,
in parallel), holds each of the six kernels against its plain PyTorch
twin at the shapes its path gives it at 4K (results must be exactly
equal), then drives four paths through the port's public functions on
3840x2160 frames, each with the launch counts set to 0 just before it and
read just after:

  1. the main path: encode 8 RGBA `mixed` frames (seeds 3..10) and 1 RGB
     `photo` frame (3 times) with qoi_tpu_torch.encode, each
     byte-identical to the C++ oracle; decode 8 `photo` and 8 `mixed`
     streams with
     decode_v3.decode_group and qoi_tpu_torch.decode, pixel-identical to
     the sources; decode the adversarial stream (INDEX reads of a
     never-written slot), which must fail the device fixpoint and match
     the oracle through the native ladder;
  2. the pack encode: pipeline.encode_device_pack on the same 8 + 1
     frames, byte-identical to the oracle;
  3. the fused staging: encode_stage.encode_stage_pallas, packed by
     pack.compact_bytes6_pack, on one mixed frame, byte-identical;
  4. the dense decode: decode_v3._decode_device(dense=True) on the 8
     photo and 8 mixed streams, pixel-identical to the sources;

and fails unless every kernel of a path was launched in that path's run.
Earlier lines report the card (name and power limit from nvidia-smi), the
build, each kernel's time beside its twin's, its bound and, for the
placement, the time of one PyTorch index_add_ computing the same words;
the per-phase times of one frame of each side path and of the main
decode (one photo and one mixed stream, every step of _decode_core and
the expand); and the rates. One
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
NFRAMES = 8
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
    from qoi_tpu_torch.kernels import slide as kslide
    from qoi_tpu_torch.models import buckets, decode_v3, pipeline
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

    px, starts, _, pix_off, conv, rounds = decode_v3._decode_core(data, clen)
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
            px, starts, _, pix_off, _, _ = core
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
        prev_bad, rounds = 0x7FFFFFFF, 0
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
        return ph, per_round, out

    for label, stream, frame in (("photo", photo_streams[1], photo[1]),
                                 ("mixed", mixed_streams[1], mixed[1])):
        data, clen = padded_body(stream)
        for _ in range(2):       # the second pass is the one reported
            ph, per_round, out = decode_phases(data, clen)
            _, t_all = sync_ms(
                lambda: decode_v3._decode_device(data, clen, npc))
        check(bool((out[:n] == want_px(frame)).all()),
              f"phase decode {label}: pixels differ")
        total = sum(ph.values()) + sum(sum(v) for v in per_round.values())
        rounds_txt = ", ".join(
            f"{k} " + " / ".join(f"{x:.3f}" for x in v)
            for k, v in per_round.items() if v)
        log(f"phases, main decode 1x4K {label} (ms): " + ", ".join(
            f"{k} {v:.3f}" for k, v in ph.items() if k != "expand")
            + f"; per round ({len(per_round['block_maps'])}): {rounds_txt}"
            f"; expand {ph['expand']:.3f}; sum {total:.3f} (_decode_device "
            f"in one bracket {t_all:.3f})")
        del data, out

    # ---- the paths, each counted on its own ---------------------------
    counts_total = {k: 0 for k in _build.launches}

    def counted(label, needs, fn):
        """Run one path with the launch counts and the peak-memory counter
        reset just before it, and read both just after."""
        torch.cuda.synchronize()
        _build.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        fn()
        torch.cuda.synchronize()
        counts = dict(_build.launches)
        log(f"launches in the {label} run: {counts}; peak device memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
        for name in needs:
            check(counts[name] > 0,
                  f"kernel {name} never launched by the {label} run")
        for k, v in counts.items():
            counts_total[k] += v

    def main_path():
        # encode: 8 RGBA mixed + 1 RGB photo (3 times, its one-frame time
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

    counted("main-path", ("slide_val", "expand_px", "block_maps"), main_path)
    counted("pack-encode", ("place_words",), pack_path)
    counted("staging", ("encode_stage", "place_words"), staging_path)
    counted("dense-decode", ("slide_val2", "block_maps", "expand_px"),
            dense_path)
    log(f"launches over the four counted runs: {counts_total}")
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
