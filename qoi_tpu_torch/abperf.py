"""Same-process A/B harness of the port on one card (the counterpart of
the repository's tools/abperf.py).

    python -m qoi_tpu_torch.abperf encode   # word-sum seg, pack, batch API
    python -m qoi_tpu_torch.abperf decode   # v3 variants, v1, `abl <phase>`
    python -m qoi_tpu_torch.abperf expand   # the expand kernel alone
    python -m qoi_tpu_torch.abperf pack     # the pack encode's phases
    python -m qoi_tpu_torch.abperf decode --mini --device cpu --check-only

Every variant runs in this one process and is verified before it is
timed: an encode must give the oracle's bytes for every frame; a decode
the source pixels for every stream (compared on the device) with
`converged` true; an expand the plain twin's plane (and, at the 4K
shapes, the source pixels); a pack phase, finished once, the oracle's
bytes, and the placement kernel the plain twin's words. A variant that
fails its check is refused: nothing of it is timed, its line says why,
the other variants go on, and the command exits 1.

Each timed variant prints one line on stdout: its name, the minimum and
the median milliseconds of --reps calls (CUDA events around each call),
the number of calls and, where it produces pixels, Mpx/s at the minimum.
Diagnostics go to stderr. Timing needs a CUDA device: without
--check-only any other device raises; --check-only verifies every
variant on any device and prints "<name>: verified" instead.

Subcommands and variants (`--only a,b` runs the variants whose names
contain one of the substrings):
- encode, --frames `testimages.mixed` 4K frames: `wordsum10240`,
  `wordsum20480`, `wordsum40960` (`pipeline.encode_device_wordsum` at that
  many pixels a compaction row: the staging kernel, then the
  compaction), `plainstage20480` (the same with the staging
  in plain torch, `pipeline.stage_chunks_plain`), `pack`
  (`encode_device_pack`),
  `batch` (`models/batch.encode_batch`) and `facade` (the
  `qoi_tpu_torch.encode` loop); the last two include the host's upload
  and fetch;
- decode, --streams streams (at most 8 unique, --content photo or mixed):
  `v3 surgical` (`decode_v3._decode_device` with the surgical round),
  `v3 nosurg` (`decode_group`), `v3 r1` (max_rounds=1, photo only),
  `v3 scanapply` (apply="scan": pass 3 as the numeric_scan kernel),
  `v3 dense` (dense=True: slide_val2, then the expand), `v1`
  (`decode_pipeline._decode_chunks`), and the ablation ladder
  `abl <phase>`: the cumulative prefix of a decode ending at `starts`
  (`fsm.chunk_starts_and_state`: the fsm_starts kernel), `fields`,
  `initial_w` (`initial_w_scan` from the bytes and starts), `round1`
  (block_maps, compose, apply and the certificate), `anchored_w` and
  `expand` (the whole decode without the surgical round), each checked
  against the full decode's intermediates;
- expand: `expand 4k per-byte` and `expand 4k dense` on one --content 4K
  stream's decode, and `expand synthetic`, the JAX harness's run-length
  mix of 2**24 bytes rebuilt with numpy from seed 7;
- pack, one mixed 4K frame: `pack full`, `pack stages`,
  `pack densify sort`, `pack densify shift`, `pack prep` and
  `pack place_words`.
--mini shrinks the frames to 320x192, the synthetic expand to 2**17 bytes
and the default reps to 2.
"""
from __future__ import annotations

import argparse
import statistics
import sys
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, List, Optional

import numpy as np
import torch

from . import _device
from . import format as fmt
from . import oracle
from ._bits import to_i32
from .models import decode_pipeline, decode_v3, pipeline
from .ops import compact
from .utils import testimages

W, H = 3840, 2160
MINI_W, MINI_H = 320, 192
REPS = 6
MINI_REPS = 2
SEED = 3
#: the synthetic expand's bytes (full and --mini)
EXPAND_M = 1 << 24
MINI_EXPAND_M = 1 << 17
#: decode sources made at most (more streams repeat them)
MAX_UNIQUE = 8
ABL_PHASES = ("starts", "fields", "initial_w", "round1", "anchored_w",
              "expand")


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


class VerifyFailed(Exception):
    """A variant's output differs from the oracle, the sources or its
    plain twin."""


def _need(ok: bool, what: str) -> None:
    if not ok:
        raise VerifyFailed(what)


class Harness:
    """Runs the selected variants: verify first, then time (or not)."""

    def __init__(self, opts, dev: torch.device):
        self.only = [t for t in opts.only.split(",") if t]
        self.reps = opts.reps
        self.check_only = opts.check_only
        self.dev = dev
        #: names of the variants that failed their check
        self.refused: List[str] = []

    def selected(self, name: str) -> bool:
        return not self.only or any(t in name for t in self.only)

    def run(self, name: str, fn: Callable, verify: Callable,
            px: Optional[int] = None) -> None:
        """Verify fn()'s output with verify(out) (which raises
        VerifyFailed), then time `reps` calls of fn by CUDA events and
        print the variant's line; `px` pixels make the Mpx/s. A variant
        that fails its check gets a `refused` line and is not timed."""
        if not self.selected(name):
            return
        try:
            verify(fn())
        except VerifyFailed as e:
            self.refused.append(name)
            print(f"{name}: refused, not timed: {e}", flush=True)
            return
        if self.check_only:
            print(f"{name}: verified", flush=True)
            return
        ts = []
        for _ in range(self.reps):
            torch.cuda.synchronize(self.dev)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            ts.append(start.elapsed_time(end))
        mn, md = min(ts), statistics.median(ts)
        rate = (f"{px / 1e3 / mn:.3f} Mpx/s" if px else "no pixels")
        print(f"{name}: min {mn:.3f} ms, median {md:.3f} ms, N {len(ts)}, "
              f"{rate}", flush=True)
        log(f"{name}: all ms {[round(t, 3) for t in ts]}")


def _frames(gen, w: int, h: int, seeds) -> list:
    """RGBA test frames, made on host threads (numpy releases the
    interpreter lock for most of the work)."""
    with ThreadPoolExecutor(8) as pool:
        return list(pool.map(lambda k: gen(w, h, 4, seed=k), seeds))


def _packed(frame: np.ndarray, dev: torch.device) -> torch.Tensor:
    """(N,) int32 on `dev`: the RGBA frame's pixels as little-endian
    words."""
    return torch.from_numpy(np.ascontiguousarray(frame).reshape(-1, 4)
                            .view(np.int32).reshape(-1)).to(dev)


def _stream_of(desc, words_or_bytes: torch.Tensor, total) -> bytes:
    """Header + the first `total` bytes of a device buffer + trailer."""
    tot = int(total)
    raw = words_or_bytes.cpu().numpy().view(np.uint8)[:tot]
    return fmt.pack_header(desc) + raw.tobytes() + fmt.TRAILER


# ---- encode ---------------------------------------------------------------

def cmd_encode(h: Harness, opts) -> None:
    import qoi_tpu_torch
    from .models import batch

    desc = fmt.StreamDesc(opts.width, opts.height, 4)
    n = desc.num_pixels
    cap = -(-n // 1024) * 1024
    frames = _frames(testimages.mixed, desc.width, desc.height,
                     range(opts.seed, opts.seed + opts.frames))
    want = [oracle.encode(f, desc) for f in frames]
    xs = []
    for f in frames:
        px = np.zeros((cap, 4), np.uint8)
        px[:n] = f.reshape(-1, 4)
        xs.append(torch.from_numpy(px).to(h.dev))
    npx = len(frames) * n

    def device_streams(outs):
        for i, (buf, tot) in enumerate(outs):
            _need(_stream_of(desc, buf, tot) == want[i],
                  f"frame {i}: not the oracle's bytes")

    def host_streams(outs):
        for i, s in enumerate(outs):
            _need(s == want[i], f"frame {i}: not the oracle's bytes")

    def plain_staged(x):
        ch = pipeline.stage_chunks_plain(x, n)
        return compact.compact_words6_wordsum(ch.lo, ch.hi, ch.lens,
                                              x.shape[0] * 6, seg=20480)

    for seg in (10240, 20480, 40960):
        h.run(f"wordsum{seg}",
              lambda seg=seg: [pipeline.encode_device_wordsum(x, n, seg=seg)
                               for x in xs], device_streams, npx)
    h.run("plainstage20480",
          lambda: [plain_staged(x) for x in xs], device_streams, npx)
    h.run("pack", lambda: [pipeline.encode_device_pack(x, n) for x in xs],
          device_streams, npx)
    h.run("batch", lambda: batch.encode_batch(frames, device=h.dev),
          host_streams, npx)
    h.run("facade", lambda: [qoi_tpu_torch.encode(f, device=h.dev)
                             for f in frames], host_streams, npx)


# ---- decode ---------------------------------------------------------------

def _abl_prefix(phase: str, data: torch.Tensor, clen: int, npc: int) -> dict:
    """The decode of one stream up to the end of `phase`, with the
    intermediates the check reads."""
    from .ops import fsm

    if phase == "expand":
        out, conv, rounds = decode_v3._decode_device(data, clen, npc,
                                                     surgical=False)
        return {"out": out, "conv": conv, "rounds": rounds}
    if phase == "starts":
        return {"starts": fsm.chunk_starts_and_state(data, clen)[0]}
    starts, cls, r6, d32, lit32, npix = decode_v3._fields(data, clen)
    got = {"starts": starts, "npix": npix}
    if phase == "fields":
        return got
    # the routes _decode_core takes: the starts kernel inside _fields, then
    # the initial scan from the bytes
    w0i, pix_off = decode_v3.initial_w_scan(data, starts)
    w0 = torch.where(starts, w0i, 0)
    got["pix_off"] = pix_off
    if phase == "initial_w":
        return got
    m = data.shape[0]
    b = decode_v3._scan_block_len(m)
    planes = (decode_v3._pos_major((cls | (r6 << 9)).to(torch.int32), m, b),
              decode_v3._pos_major(to_i32(d32), m, b),
              decode_v3._pos_major(to_i32(lit32), m, b))
    px, _, _ = decode_v3._resolve_p(*planes, w0, m, b)
    got["px1"] = px
    got["bad1"] = int((torch.where(starts, decode_v3._hash_packed(px), 0)
                       != w0).sum())
    if phase == "round1":
        return got
    got["w1"] = torch.where(starts, decode_v3._anchored_w(cls, r6, d32, px),
                            0)
    return got


def cmd_decode(h: Harness, opts) -> None:
    desc = fmt.StreamDesc(opts.width, opts.height, 4)
    n = desc.num_pixels
    ns = opts.streams
    nu = min(ns, MAX_UNIQUE)
    gen = getattr(testimages, opts.content)
    frames = _frames(gen, desc.width, desc.height,
                     range(opts.seed, opts.seed + nu))
    streams = [oracle.encode(f, desc) for f in frames]
    raws = [np.frombuffer(s, np.uint8)[fmt.HEADER_SIZE:] for s in streams]
    clens = [len(s) - fmt.HEADER_SIZE - fmt.TRAILER_SIZE for s in streams]
    npc = decode_pipeline.bucket_size(n)
    want = [_packed(f, h.dev) for f in frames]
    rows = [i % nu for i in range(ns)]

    def batch_of(m):
        bodies = np.zeros((nu, m), np.uint8)
        for i, r in enumerate(raws):
            bodies[i, : len(r)] = r
        return torch.from_numpy(bodies).to(h.dev)[rows]

    # v3's quarter-power-of-two bucket, v1's power of two
    db = batch_of(decode_pipeline.bucket_size_fine(max(map(len, raws))))
    dc = [clens[r] for r in rows]
    log(f"decode: {ns} {opts.content} streams of {desc.width}x"
        f"{desc.height} ({nu} unique), bucket {db.shape[1]} bytes, "
        f"{npc} px")

    def source_px(i, out, conv, rounds=None):
        _need(bool(conv), f"stream {i} did not converge"
              + ("" if rounds is None else f" in {rounds} rounds"))
        _need(bool(torch.equal(out[:n], want[rows[i]])),
              f"stream {i}: not the source pixels")

    def pixels(outs):
        """outs: (out (npc,) int32, converged, rounds) a stream."""
        for i, (out, conv, rounds) in enumerate(outs):
            source_px(i, out, conv, rounds)

    def each(**kw):
        return lambda: [decode_v3._decode_device(db[i], dc[i], npc, **kw)
                        for i in range(ns)]

    npx = ns * n
    h.run("v3 surgical", each(surgical=True), pixels, npx)
    h.run("v3 nosurg", lambda: decode_v3.decode_group(db, dc, npc),
          lambda o: pixels(list(zip(*o))), npx)
    if opts.content == "photo":
        h.run("v3 r1", each(max_rounds=1, surgical=False), pixels, npx)
    elif h.selected("v3 r1"):
        log("v3 r1: photo only (on mixed content one round does not "
            "converge, so it could not be verified)")
    h.run("v3 scanapply", each(apply="scan", surgical=False), pixels, npx)
    h.run("v3 dense", each(dense=True, surgical=False), pixels, npx)

    if h.selected("v1"):
        d1 = batch_of(decode_pipeline.bucket_size(max(map(len, raws))))

        def v1_pixels(outs):
            pixels([(px4.reshape(-1).view(torch.int32), conv, it)
                    for px4, conv, it in outs])

        h.run("v1", lambda: [decode_pipeline._decode_chunks(d1[i], dc[i], npc)
                             for i in range(ns)], v1_pixels, npx)
        del d1

    phases = [p for p in ABL_PHASES if h.selected("abl " + p)]
    if not phases:
        return
    # the full decode's intermediates, one a unique stream
    full = []
    for i in range(nu):
        px, starts, npix, pix_off, conv, rounds, _ = decode_v3._decode_core(
            db[i], dc[i], surgical=False)
        _need(conv, f"full decode of stream {i} did not converge")
        full.append({"px": px, "starts": starts, "npix": npix,
                     "pix_off": pix_off, "rounds": rounds})

    def ladder(phase):
        def verify(outs):
            for i, got in enumerate(outs):
                ref = full[rows[i]]
                if phase == "expand":
                    source_px(i, got["out"], got["conv"])
                    _need(got["rounds"] == ref["rounds"],
                          f"stream {i}: {got['rounds']} rounds, the full "
                          f"decode {ref['rounds']}")
                    continue
                for k in ("starts", "npix", "pix_off"):
                    if k in got:
                        _need(bool(torch.equal(got[k], ref[k])),
                              f"stream {i}: {k} differs from the full "
                              "decode's")
                if "px1" in got:
                    _need((got["bad1"] == 0) == (ref["rounds"] == 1),
                          f"stream {i}: round 1 left {got['bad1']} "
                          f"mismatches, the full decode took "
                          f"{ref['rounds']} rounds")
                    if ref["rounds"] == 1:
                        _need(bool(torch.equal(got["px1"], ref["px"])),
                              f"stream {i}: round 1 px differ")
                if "w1" in got and ref["rounds"] <= 2:
                    true_w = torch.where(
                        ref["starts"], decode_v3._hash_packed(ref["px"]), 0)
                    _need(bool(torch.equal(got["w1"], true_w)),
                          f"stream {i}: the anchored w is not the decode's "
                          "written slots")
        return verify

    for phase in phases:
        h.run("abl " + phase,
              lambda phase=phase: [_abl_prefix(phase, db[i], dc[i], npc)
                                   for i in range(ns)],
              ladder(phase), npx)


# ---- expand ---------------------------------------------------------------

def _synthetic_expand(m: int):
    """The JAX harness's expand input (tools/abperf.py cmd_expand): a
    run-length mix over m bytes from numpy seed 7. Returns (pix_off (m,)
    int32, px32 (m,) int32, n_px_cap)."""
    rng = np.random.default_rng(7)
    cap = m // 2 + m // 16
    lens = rng.choice([1, 1, 1, 2, 2, 4, 5], size=m // 2)
    sp = np.cumsum(lens) - lens[0]
    sp = sp[sp < m]
    npix = np.zeros(m, np.int64)
    npix[sp] = np.where(rng.random(len(sp)) < 0.03,
                        rng.integers(2, 63, len(sp)), 1)
    po = np.concatenate([[0], np.cumsum(npix)[:-1]]).astype(np.int32)
    px = np.zeros(m, np.uint32)
    px[sp] = rng.integers(0, 1 << 32, len(sp),
                          dtype=np.uint64).astype(np.uint32)
    starts = np.zeros(m, bool)
    starts[sp] = True
    px = np.maximum.accumulate(np.where(starts, px, 0)).astype(np.uint32)
    return po, px.view(np.int32), cap


def cmd_expand(h: Harness, opts) -> None:
    from .kernels.expand import expand_px, expand_px_xla

    desc = fmt.StreamDesc(opts.width, opts.height, 4)
    n = desc.num_pixels
    npc = decode_pipeline.bucket_size(n)

    def plane(want_px, po, px, cap):
        def verify(out):
            _need(bool(torch.equal(out, expand_px_xla(po, px, cap))),
                  "differs from the plain twin")
            if want_px is not None:
                _need(bool(torch.equal(out[:n], want_px)),
                      "not the source pixels")
        return verify

    if h.selected("expand 4k"):
        frame = _frames(getattr(testimages, opts.content), desc.width,
                        desc.height, [opts.seed])[0]
        stream = oracle.encode(frame, desc)
        raw = np.frombuffer(stream, np.uint8)[fmt.HEADER_SIZE:]
        pad = np.zeros(decode_pipeline.bucket_size_fine(len(raw)), np.uint8)
        pad[: len(raw)] = raw
        px, starts, _, pix_off, conv, _, _ = decode_v3._decode_core(
            torch.from_numpy(pad).to(h.dev), len(raw) - fmt.TRAILER_SIZE)
        _need(conv, "the 4K decode did not converge")
        want = _packed(frame, h.dev)
        po, p32 = pix_off.to(torch.int32), to_i32(px)
        h.run("expand 4k per-byte", lambda: expand_px(po, p32, npc),
              plane(want, po, p32, npc), npc)
        off_d, px_d = decode_v3._compact_chunks(starts, pix_off, px)
        del px, starts, pix_off
        h.run("expand 4k dense", lambda: expand_px(off_d, px_d, npc),
              plane(want, off_d, px_d, npc), npc)
        del po, p32, off_d, px_d
    if h.selected("expand synthetic"):
        po, px, cap = _synthetic_expand(opts.expand_m)
        spo, spx = (torch.from_numpy(x).to(h.dev) for x in (po, px))
        h.run("expand synthetic", lambda: expand_px(spo, spx, cap),
              plane(None, spo, spx, cap), cap)


# ---- pack -----------------------------------------------------------------

def cmd_pack(h: Harness, opts) -> None:
    from .kernels import pack as kpack

    desc = fmt.StreamDesc(opts.width, opts.height, 4)
    n = desc.num_pixels
    cap = -(-n // 4096) * 4096
    frame = _frames(testimages.mixed, desc.width, desc.height,
                    [opts.seed])[0]
    want = oracle.encode(frame, desc)
    px4 = np.zeros((cap, 4), np.uint8)
    px4[:n] = frame.reshape(-1, 4)
    x = torch.from_numpy(px4).to(h.dev)

    def stream(out):
        _need(_stream_of(desc, *out) == want, "not the oracle's bytes")

    def finished(out):
        """Dense records finished by the placement: the oracle's bytes."""
        off_d, lo_d, hi_d = out[:3]
        stream(kpack.place_records(off_d, lo_d, hi_d, total, cap * 6))

    h.run("pack full", lambda: pipeline.encode_device_pack(x, n), stream, n)
    ch = pipeline.encode_stage_chunks(x, n, form="bytes")
    st, ln = ch.staging, ch.lens
    total = ln.to(torch.int64).sum()
    h.run("pack stages",
          lambda: pipeline.encode_stage_chunks(x, n, form="bytes"),
          lambda c: stream(kpack.compact_bytes6_pack(c.staging, c.lens,
                                                     cap * 6)), n)
    h.run("pack densify sort", lambda: kpack._densify_sort(st, ln),
          finished, n)
    h.run("pack densify shift", lambda: kpack._densify_shift(st, ln),
          finished, n)
    off_d, lo_d, hi_d, _ = kpack.densify_records(st, ln)
    del ch, st

    def placed(planes):
        wp, c0, c1 = planes
        words = kpack.place_words(wp.to(torch.int32), to_i32(c0), to_i32(c1),
                                  cap * 6 // 4)
        stream((words.view(torch.uint8), total))

    h.run("pack prep", lambda: kpack._prep_planes(off_d, lo_d, hi_d, total),
          placed, n)
    wp, c0, c1 = kpack._prep_planes(off_d, lo_d, hi_d, total)
    wp, c0, c1 = wp.to(torch.int32), to_i32(c0), to_i32(c1)

    def words(out):
        _need(bool(torch.equal(
            out, kpack.place_words_plain(wp, c0, c1, cap * 6 // 4))),
            "differs from the plain twin")
        stream((out.view(torch.uint8), total))

    h.run("pack place_words",
          lambda: kpack.place_words(wp, c0, c1, cap * 6 // 4), words, n)


COMMANDS = {"encode": cmd_encode, "decode": cmd_decode,
            "expand": cmd_expand, "pack": cmd_pack}


def _parse(argv):
    ap = argparse.ArgumentParser(
        prog="python -m qoi_tpu_torch.abperf",
        description="Same-process A/B harness of the port: every variant "
                    "verified, then timed by CUDA events (min and median "
                    "of N).")
    ap.add_argument("what", choices=sorted(COMMANDS))
    ap.add_argument("--only", default="",
                    help="comma-separated substrings: run only the variants "
                         "whose names contain one")
    ap.add_argument("--mini", action="store_true",
                    help=f"{MINI_W}x{MINI_H} frames, a 2**17-byte synthetic "
                         f"expand, {MINI_REPS} reps by default")
    ap.add_argument("--content", default="photo", choices=("photo", "mixed"),
                    help="test image class of the decode and expand streams")
    ap.add_argument("--reps", type=int, default=None,
                    help=f"timed calls a variant (default {REPS}, "
                         f"{MINI_REPS} with --mini)")
    ap.add_argument("--seed", type=int, default=SEED,
                    help=f"seed of the first frame (default {SEED})")
    ap.add_argument("--frames", type=int, default=8,
                    help="encode: frames (default 8)")
    ap.add_argument("--streams", type=int, default=16,
                    help=f"decode: streams (default 16; at most "
                         f"{MAX_UNIQUE} unique sources, repeated)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; timing needs a card)")
    ap.add_argument("--check-only", action="store_true",
                    help="verify every variant on any device, time nothing")
    opts = ap.parse_args(argv)
    if opts.reps is None:
        opts.reps = MINI_REPS if opts.mini else REPS
    opts.width, opts.height = (MINI_W, MINI_H) if opts.mini else (W, H)
    opts.expand_m = MINI_EXPAND_M if opts.mini else EXPAND_M
    if min(opts.reps, opts.frames, opts.streams) < 1:
        ap.error("--reps, --frames and --streams must be at least 1")
    return opts


def main(argv: Optional[List[str]] = None) -> int:
    opts = _parse(argv)
    dev = _device(opts.device)
    if not opts.check_only and dev.type != "cuda":
        raise RuntimeError(
            f"timing needs a CUDA device, got {opts.device!r}; --check-only "
            "verifies the variants on any device")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    log(f"device: {name}; {opts.what} at {opts.width}x{opts.height}, reps "
        f"{opts.reps}")
    h = Harness(opts, dev)
    try:
        COMMANDS[opts.what](h, opts)
    except VerifyFailed as e:       # a check of the inputs, before any variant
        log(f"VERIFY FAILED: {e}")
        return 1
    if h.refused:
        log(f"refused, not timed: {h.refused}")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
