"""Data-parallel QOI encoder (port of qoi_tpu/models/pipeline.py, the
`encode_device_wordsum` main path).

The reference encoder's four loop carries (px_prev, run, index[64], write
cursor -- qoi.h:406-478) each become a parallel stage:

  1. pixel prep       px_prev = shift(px); eq mask
  2. run segmentation distance to the last literal      (ops/scans.py)
  3. table replay     last-writer-wins                  (ops/table.py)
  4. classification   per-record words by SWAR on packed u32 lanes
  5-6. offsets and compaction: the word-sum compaction  (ops/compact.py)

Three compactions follow the stages: the word-sum one above (the main
path, `encode_device_wordsum`, and the tiles of parallel/tiled.py), the
record pack of kernels/pack.py (`encode_device_pack`, over the
byte-plane staging `form="bytes"`) and the two-tier sort
`compact.compact_bytes6` (`encode_device_split`, whose table runs in
two phases).

u32 values are int64 in [0, 2**32) (see _bits), except the staging's on
the card: the staging kernels (kernels/encode_stage,
`csrc/encode_stage.cu`) return the word form's lo, hi and lens and the
byte-plane form's lens as int32 (bit patterns), where the plain code
returns int64.

Spans (utils/profiling.annotate; record_function ranges while a profiler
runs, free otherwise): `qoi.encode` is one `encode_device_wordsum` call,
with `qoi.encode.stage_chunks` (every `encode_stage_chunks` call) and
`qoi.encode.compact` (ops/compact.compact_words6_wordsum) inside it.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from .. import format as fmt
from .._bits import M32, swar_add, swar_sub
from ..kernels import encode_stage as kstage
from ..kernels import pack as kpack
from ..ops import compact, scans, table
from ..utils.profiling import annotate
from .decode_pipeline import bucket_size

_SEED = fmt.SEED_PIXEL


class EncoderCarry(NamedTuple):
    """The reference encoder's carries at a tile boundary."""

    prev_px: torch.Tensor  # (4,) uint8 last pixel of the tile
    run: torch.Tensor      # 0-d int64 pending (unemitted) run length, 0..61
    table: torch.Tensor    # (64,) int64 u32 packed table values
    written: torch.Tensor  # (64,) bool slots ever written


def carry_from_numpy(carry, device) -> EncoderCarry:
    """An EncoderCarry of numpy arrays (e.g. the JAX package's carry after
    np.asarray on each field: uint8, int32, uint32, bool) -> the port's."""
    prev_px, run, tbl, written = (np.asarray(x) for x in carry)
    return EncoderCarry(
        torch.from_numpy(prev_px.astype(np.uint8)).to(device),
        torch.tensor(int(run), dtype=torch.int64, device=device),
        torch.from_numpy(tbl.astype(np.uint32).astype(np.int64)).to(device),
        torch.from_numpy(written.astype(bool)).to(device))


def carry_to_numpy(carry: EncoderCarry) -> Tuple[np.ndarray, ...]:
    """The port's carry -> numpy arrays in the JAX carry's dtypes."""
    return (carry.prev_px.cpu().numpy().astype(np.uint8),
            np.int32(carry.run.item()),
            carry.table.cpu().numpy().astype(np.uint32),
            carry.written.cpu().numpy().astype(bool))


class EncodedWords(NamedTuple):
    """Per-pixel chunk records in packed word form. lo, hi and lens are
    int32 bit patterns from the staging kernel (CUDA tensors) and int64
    from the plain code: every reader widens them with `_bits.u32`."""

    lo: torch.Tensor    # (N,) int32 or int64 u32 values: stream bytes 0..3,
                        # little-endian
    hi: torch.Tensor    # (N,) int32 or int64 u32 values: stream bytes 4..5
                        # in the low 16 bits
    lens: torch.Tensor  # (N,) int32 or int64 u32 values: emitted byte
                        # count (0 for run members)
    carry: EncoderCarry


class EncodedChunks(NamedTuple):
    """Per-pixel chunk staging in byte-plane form."""

    staging: torch.Tensor  # (6, N) uint8 byte planes: [flush?] + chunk bytes
    lens: torch.Tensor     # (N,) emitted byte count (0 for run members):
                           # int32 from the staging kernel (CUDA tensors),
                           # int64 from the plain code
    carry: EncoderCarry


def encode_stage_chunks(
    px4: torch.Tensor,
    n_valid=None,
    *,
    prev_in: Optional[torch.Tensor] = None,
    run_in=None,
    table_in: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    contains_last=None,
    table_local=None,
    table_block: int = table._BLOCK,
    form: str = "words",
    last_pos=None,
    run_resets: Optional[torch.Tensor] = None,
):
    """Stages 1-4: per-pixel records and lengths, as the JAX
    `encode_stage_chunks`. form="words" (the port's default, the main
    path) returns EncodedWords; form="bytes" (the JAX default) returns
    EncodedChunks with the (6, N) byte planes, which leave a run byte in
    s0 of run members that emit nothing (len 0), as the JAX planes do.

    px4: (N, 4) uint8 with alpha 255 for 3-channel sources. Positions >=
    `n_valid` are padding: forced onto the run branch so they never write
    the table, with their emission points masked off. The incoming
    cross-tile carry: prev_in (4,) uint8 boundary pixel (default the
    seed), run_in pending run length, table_in (table (64,) u32, written
    (64,) bool), contains_last whether this tile holds the stream's final
    pixel (the end-of-stream run flush, qoi.h:417). `table_local`, a
    `table.table_hit_local` output at `table_block`, runs the table's
    phase B alone (`encode_device_split`).

    Port only, for the fused staging kernel's twin (kernels/encode_stage):
    last_pos overrides the final pixel's index, and run_resets (N,) bool
    cuts the pending run before the marked positions
    (`scans.run_segmentation`).

    On a CUDA tensor each form is one launch of a staging kernel:
    form="words" of `kernels/encode_stage.encode_stage_words` (the main
    path, the streamed encode's tiles and the sequence-parallel encode's
    phase B), form="bytes" of `encode_stage_planes` (the pack encode).
    table_local=, last_pos= and run_resets= keep the plain code on every
    device: table_local= serves `encode_device_split` (the kernel replays
    the table itself, so a precomputed block-local table has nothing to
    feed), the other two the fused staging's twin."""
    with annotate("qoi.encode.stage_chunks"):
        if (px4.device.type == "cuda" and table_local is None
                and last_pos is None and run_resets is None
                and form in ("words", "bytes")):
            stage = (kstage.encode_stage_words if form == "words"
                     else kstage.encode_stage_planes)
            return stage(px4, n_valid, prev_in=prev_in, run_in=run_in,
                         table_in=table_in, contains_last=contains_last)
        return stage_chunks_plain(
            px4, n_valid, prev_in=prev_in, run_in=run_in, table_in=table_in,
            contains_last=contains_last, table_local=table_local,
            table_block=table_block, form=form, last_pos=last_pos,
            run_resets=run_resets)


def stage_chunks_plain(
    px4: torch.Tensor,
    n_valid=None,
    *,
    prev_in: Optional[torch.Tensor] = None,
    run_in=None,
    table_in: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    contains_last=None,
    table_local=None,
    table_block: int = table._BLOCK,
    form: str = "words",
    last_pos=None,
    run_resets: Optional[torch.Tensor] = None,
):
    """`encode_stage_chunks` in plain torch on any device (its CPU route,
    and the twin of the words and planes kernels, `kernels/encode_stage.
    encode_stage_words_plain` and `encode_stage_planes_plain`), its lo,
    hi and lens int64."""
    n = px4.shape[0]
    dev = px4.device
    io = torch.arange(n, device=dev)
    if n_valid is None:
        valid = torch.ones(n, dtype=torch.bool, device=dev)
        final = n - 1
    else:
        n_valid = torch.as_tensor(n_valid, dtype=torch.int64, device=dev)
        valid = io < n_valid
        final = n_valid - 1
    if contains_last is not None:
        final = torch.where(
            torch.as_tensor(contains_last, device=dev),
            torch.as_tensor(final, device=dev), -1)
    if last_pos is None:
        last_pos = final

    # -- stage 1: previous pixel, compared as one packed u32 per pixel
    if prev_in is None:
        prev_in = torch.tensor(_SEED, dtype=torch.uint8, device=dev)
    packed = table.pack_rgba(px4)
    prev32 = torch.cat([table.pack_rgba(prev_in.to(torch.uint8))[None],
                        packed[:-1]])
    eq = (packed == prev32) | ~valid

    # -- stage 2: run segmentation
    runs = scans.run_segmentation(eq, last_pos=last_pos, run_in=run_in,
                                  resets=run_resets)
    emits_run = runs.emits_run & valid

    # -- stage 3: color-table replay (only literal pixels write)
    keys = table.hash64(px4)
    if table_local is None:
        hit0, (tbl_out, wr_out) = table.table_hit(keys, packed, write=~eq,
                                                  incoming=table_in)
    else:
        hit0, (tbl_out, wr_out) = table.table_hit_carry(
            table_local, keys, packed, block=table_block, incoming=table_in)
    hit = ~eq & hit0

    # -- stage 4: op classification, SWAR on the packed u32 lanes; range
    # tests use v in [-k, m) <=> (v + k) mod 256 < k + m
    d32s = swar_sub(packed, prev32)          # per-byte mod-256 diffs
    alpha_same = (d32s >> 24) == 0
    t2 = swar_add(d32s, 0x00020202)          # (dr+2, dg+2, db+2)
    is_diff = alpha_same & ((t2 & 0x00FCFCFC) == 0)
    vr8 = d32s & 0xFF
    vg8 = (d32s >> 8) & 0xFF
    vb8 = (d32s >> 16) & 0xFF
    g32 = (vg8 + 32) & 0xFF
    gr16 = (vr8 - vg8 + 8) & 0xFF
    gb16 = (vb8 - vg8 + 8) & 0xFF
    is_luma = (alpha_same & ~is_diff
               & (g32 < 64) & (gr16 < 16) & (gb16 < 16))
    is_rgb = alpha_same & ~is_diff & ~is_luma

    diff_b0 = (fmt.OP_DIFF | (t2 & 3) << 4 | ((t2 >> 8) & 3) << 2
               | ((t2 >> 16) & 3))
    luma_b0 = fmt.OP_LUMA | g32
    luma_b1 = (gr16 << 4) | gb16
    idx_byte = fmt.OP_INDEX | keys
    run_byte = (fmt.OP_RUN | (runs.run_val - 1)) & 0xFF
    flush_byte = (fmt.OP_RUN | (runs.flush_val - 1)) & 0xFF
    fl = runs.flush
    own_len = torch.where(hit | is_diff, 1,
              torch.where(is_luma, 2, torch.where(is_rgb, 4, 5)))
    lens = torch.where(eq, emits_run.to(torch.int64),
                       own_len + fl.to(torch.int64))

    if form == "words":
        # per-class whole-record words; the flush prefix and the run byte
        # apply as word-level shifts
        rgbx = (packed << 8) & 0xFFFFFF00        # r<<8 | g<<16 | b<<24
        own_lo = torch.where(hit, idx_byte,
                 torch.where(is_diff, diff_b0,
                 torch.where(is_luma, luma_b0 | luma_b1 << 8,
                 torch.where(is_rgb, fmt.OP_RGB | rgbx, fmt.OP_RGBA | rgbx))))
        own_hi = torch.where(is_rgb | hit | is_diff | is_luma, 0,
                             packed >> 24)
        lo = torch.where(fl, flush_byte | ((own_lo << 8) & M32), own_lo)
        hi = torch.where(fl, (own_lo >> 24) | own_hi << 8, own_hi)
        lo = torch.where(eq, torch.where(emits_run, run_byte, 0), lo)
        hi = torch.where(eq, 0, hi)
    elif form == "bytes":
        # byte 0: RUN for run members, the flush byte when a run is
        # pending, else the chunk head; bytes 1..5 shift one slot right
        # when a flush leads
        px = px4.to(torch.int64)
        own0 = torch.where(hit, idx_byte,
               torch.where(is_diff, diff_b0,
               torch.where(is_luma, luma_b0,
               torch.where(is_rgb, fmt.OP_RGB, fmt.OP_RGBA))))
        own1 = torch.where(hit | is_diff, 0,
                           torch.where(is_luma, luma_b1, px[:, 0]))
        short = hit | is_diff | is_luma
        own2 = torch.where(short, 0, px[:, 1])
        own3 = torch.where(short, 0, px[:, 2])
        own4 = torch.where(short | is_rgb, 0, px[:, 3])
        s0 = torch.where(eq, run_byte, torch.where(fl, flush_byte, own0))
        rest = [torch.where(eq, 0, torch.where(fl, a, b))
                for a, b in ((own0, own1), (own1, own2), (own2, own3),
                             (own3, own4))]
        s5 = torch.where(eq | ~fl, 0, own4)
        staging = torch.stack([s0, *rest, s5]).to(torch.uint8)  # (6, N)
    else:
        raise ValueError(f"form must be 'words' or 'bytes', got {form!r}")

    # -- outgoing carry at the valid-region boundary (for tile chaining);
    # pads are forced eq, so last_noneq always lands inside the region
    last_noneq = scans.last_true_index(~eq)[-1]
    n_val = torch.as_tensor(final + 1 if n_valid is None else n_valid,
                            dtype=torch.int64, device=dev)
    run_in_v = torch.as_tensor(0 if run_in is None else run_in,
                               dtype=torch.int64, device=dev)
    trail = torch.where(last_noneq < 0,
                        n_val + run_in_v,          # one run since tile start
                        (n_val - 1) - last_noneq)  # run began inside the tile
    run_out = trail % fmt.RUN_CAP
    if contains_last is not None:
        run_out = torch.where(torch.as_tensor(contains_last, device=dev),
                              0, run_out)
    last_px = torch.where(n_val > 0, px4[(n_val - 1).clamp(min=0)],
                          prev_in.to(torch.uint8))
    carry = EncoderCarry(last_px, run_out, tbl_out, wr_out)
    if form == "bytes":
        return EncodedChunks(staging, lens, carry)
    return EncodedWords(lo, hi, lens, carry)


def encode_device_wordsum(px4: torch.Tensor, n_valid, seg: int = 20480):
    """Device-resident encode: word-form staging + the word-sum
    compaction, one CUDA kernel on the card (kernels/compact_words.py).
    seg=20480 pixels per compaction row of the CPU route, as in the JAX
    package; the card's words do not depend on it. Returns (words (6*N//4,) int32 -- the stream bytes
    little-endian -- and total 0-d int64). The span `qoi.encode` is the
    request: the staging's and the compaction's spans nest in it."""
    with annotate("qoi.encode"):
        ch = encode_stage_chunks(px4, n_valid)
        return compact.compact_words6_wordsum(
            ch.lo, ch.hi, ch.lens, px4.shape[0] * 6, seg=seg)


def encode_device_split(px4: torch.Tensor, n_valid,
                        table_block: int = table._BLOCK):
    """Device-resident encode as the JAX `_encode_phase_a` and
    `_encode_phase_b` chain it: the table's block-local phase
    (`table.table_hit_local`) first, then the byte-plane stages with its
    output and the two-tier sort compaction `compact.compact_bytes6`.
    Returns (buffer (6N,) uint8, the stream in [0, total), and total)."""
    io = torch.arange(px4.shape[0], device=px4.device)
    prev = torch.cat([torch.tensor(_SEED, dtype=torch.uint8,
                                   device=px4.device)[None], px4[:-1]])
    eq = (px4 == prev).all(dim=-1) | (io >= n_valid)
    local = table.table_hit_local(table.hash64(px4), table.pack_rgba(px4),
                                  write=~eq, block=table_block)
    ch = encode_stage_chunks(px4, n_valid, table_local=local,
                             table_block=table_block, form="bytes")
    return compact.compact_bytes6(ch.staging, ch.lens, px4.shape[0] * 6)


def _encode_pack_a(px4: torch.Tensor, n_valid):
    """Program A of the splitd pack encode: byte-plane staging + record
    densify. Returns (off_d, lo_d, hi_d, total)."""
    ch = encode_stage_chunks(px4, n_valid, form="bytes")
    return kpack.densify_records(ch.staging, ch.lens)


def encode_device_pack(px4: torch.Tensor, n_valid):
    """Device-resident encode through the splitd pack structure (the JAX
    `encode_device_pack`): program A (`_encode_pack_a`), then plane prep
    and the word placement, whose kernel is `csrc/pack.cu` on the card.
    px4: (N, 4) uint8 with N a multiple of 4096 (or below it). Returns
    (buffer (6N,) uint8, the stream in [0, total) and 0 after it, total
    0-d int64)."""
    off_d, lo_d, hi_d, total = _encode_pack_a(px4, n_valid)
    return kpack.place_records(off_d, lo_d, hi_d, total, px4.shape[0] * 6)


def force_rgba(pixels: np.ndarray, desc: fmt.StreamDesc) -> np.ndarray:
    """Flatten to (N, 4) uint8, forcing alpha=255 for 3-channel input."""
    flat = np.asarray(pixels, dtype=np.uint8).reshape(-1, desc.channels)
    if flat.shape[0] != desc.num_pixels:
        raise ValueError(
            f"pixel count {flat.shape[0]} != {desc.num_pixels} "
            "from descriptor")
    if desc.channels == 3:
        flat = np.concatenate(
            [flat, np.full((flat.shape[0], 1), 255, np.uint8)], axis=1)
    return flat


def encode(pixels: np.ndarray, desc: fmt.StreamDesc, device,
           config=None) -> bytes:
    """Encode one image on `device`; byte-identical to the reference
    encoder (qoi.h:356). Pads to a power-of-two pixel bucket (at least
    `config.bucket_floor`) and fetches only the stream's words."""
    desc.validate()
    px4 = force_rgba(pixels, desc)
    n = px4.shape[0]
    floor = config.bucket_floor if config else 256
    padded = np.zeros((bucket_size(n, floor), 4), np.uint8)
    padded[:n] = px4
    words, total = encode_device_wordsum(
        torch.from_numpy(padded).to(device), n)
    total = int(total)
    body = words[: -(-total // 4)].cpu().numpy().view(np.uint8)[:total]
    return fmt.pack_header(desc) + body.tobytes() + fmt.TRAILER
