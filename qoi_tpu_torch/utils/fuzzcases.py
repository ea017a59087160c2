"""Seeded cases and the verdict of the differential fuzz of the port's
codec paths against the C++ oracle (the port's counterpart of
tests/test_fuzz.py, widened to every decode path a public entry reaches).

Importing this module needs numpy and the port's numpy leaves (format,
oracle, utils/testimages) only; the paths import the port's torch modules
when they run. The families, each a list of `Case`s made from a seed:

  a  random bytes (40, lengths 0-200, a random `channels` half the time)
  b  a valid header with a random body (30)
  c  1-5 byte mutations of the 24x18 mixed RGBA canonical stream (30)
  d  the eight bad headers
  e  the bad `channels` values -1, 1, 2, 5 and 255
  f  multi-block: 1-12 byte mutations past the header and truncations at
     random cut points, with and without the trailer, of the canonical
     streams of a 160x120 mixed RGBA, a 200x90 photo RGB and a 96x64
     palette_alpha image, `channels` in {0, 3, 4}
  g  random images of random shape and class (1xN, Nx1, under one
     1024-pixel block, just above and below multiples of 1024 pixels):
     their oracle streams are decode cases, the images encode cases
  f' (`card_cases`) the same mutations and truncations of caller-given
     large streams, for the card

(a)-(c) draw exactly as tests/test_fuzz.py does. A valid header of more
than CAP_PX pixels is dropped from (a)-(f), as there.

The verdict (`problem`): where the oracle rejects a stream (ValueError),
the path must raise ValueError; where it accepts, the path returns the
oracle's pixels and descriptor. Any other exception is a failure, not a
rejection. An encode path must return the oracle's bytes.
"""
from __future__ import annotations

import contextlib
import dataclasses
import struct
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from .. import format as fmt
from .. import oracle
from . import testimages

#: valid headers above this many pixels are dropped from (a)-(f), as in
#: tests/test_fuzz.py: correct on both sides, too big for a quick run
CAP_PX = 100_000


@dataclasses.dataclass(frozen=True)
class Case:
    """One decode input: the stream and the `channels` argument."""
    family: str
    data: bytes
    channels: int = 0


def _header(w: int, h: int, ch: int, cs: int) -> bytes:
    """A raw 14-byte header, unvalidated."""
    return b"qoif" + struct.pack(">IIBB", w, h, ch, cs)


def _stream(img: np.ndarray) -> bytes:
    h, w, ch = img.shape
    return oracle.encode(img, fmt.StreamDesc(w, h, ch))


def _capped(cases: List[Case]) -> List[Case]:
    def keep(c):
        try:
            return fmt.unpack_header(c.data).num_pixels <= CAP_PX
        except ValueError:
            return True
    return [c for c in cases if keep(c)]


def random_bytes(n: int = 40, seed: int = 0) -> List[Case]:
    """(a) random bytes, lengths 0-200; half the time a random channels
    argument in [0, 5)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        k = int(rng.integers(0, 200))
        data = rng.integers(0, 256, k, dtype=np.uint8).tobytes()
        ch = int(rng.integers(0, 5)) if rng.integers(2) else 0
        out.append(Case("a", data, ch))
    return _capped(out)


def valid_header_random_body(n: int = 30, seed: int = 1) -> List[Case]:
    """(b) a valid header (w < 40, h < 20, 3 or 4 channels), a random body
    of 0-300 bytes, the trailer."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        w = int(rng.integers(1, 40))
        h = int(rng.integers(1, 20))
        ch = int(rng.choice([3, 4]))
        body = rng.integers(0, 256, int(rng.integers(0, 300)),
                            dtype=np.uint8).tobytes()
        out.append(Case("b", _header(w, h, ch, 0) + body + fmt.TRAILER))
    return _capped(out)


def mutated_canonical(n: int = 30, seed: int = 2) -> List[Case]:
    """(c) 1-5 random bytes, header included, of the 24x18 mixed RGBA
    canonical stream set to random values."""
    rng = np.random.default_rng(seed)
    base = _stream(testimages.mixed(24, 18, 4))
    out = []
    for _ in range(n):
        data = bytearray(base)
        for _ in range(int(rng.integers(1, 6))):
            data[int(rng.integers(0, len(data)))] = int(rng.integers(0, 256))
        out.append(Case("c", bytes(data)))
    return _capped(out)


def bad_headers() -> List[Case]:
    """(d) the eight headers tests/test_fuzz.py's test_rejects_bad_headers
    feeds."""
    t = fmt.TRAILER
    return [Case("d", x) for x in (
        b"",
        b"qoif",
        _header(0, 10, 4, 0) + t,               # zero width
        _header(10, 0, 4, 0) + t,               # zero height
        _header(10, 10, 2, 0) + t,              # bad channels
        _header(10, 10, 4, 2) + t,              # bad colorspace
        b"QOIF" + _header(4, 4, 4, 0)[4:] + t,  # bad magic
        _header(65536, 65536, 4, 0) + t,        # pixel cap (qoi.h:332)
    )]


def bad_channels() -> List[Case]:
    """(e) a valid 4x4 stream with each channels value the API refuses."""
    data = _stream(np.zeros((4, 4, 4), np.uint8))
    return [Case("e", data, ch) for ch in (-1, 1, 2, 5, 255)]


def mutations(family: str, base: bytes, n: int, rng, max_bytes: int = 12,
              channels: Sequence[int] = (0, 3, 4)) -> List[Case]:
    """n copies of `base` with 1..max_bytes random bytes past the header
    set to random values, each with a channels argument drawn from
    `channels`."""
    out = []
    for _ in range(n):
        data = bytearray(base)
        for _ in range(int(rng.integers(1, max_bytes + 1))):
            data[int(rng.integers(fmt.HEADER_SIZE, len(data)))] = int(
                rng.integers(0, 256))
        out.append(Case(family, bytes(data), int(rng.choice(channels))))
    return out


def truncations(family: str, base: bytes, n: int, rng,
                channels: Sequence[int] = (0, 3, 4)) -> List[Case]:
    """n copies of `base` cut at a random point in [0, len), half of them
    with the trailer put back after the cut."""
    out = []
    for _ in range(n):
        cut = int(rng.integers(0, len(base)))
        data = base[:cut] + (fmt.TRAILER if rng.integers(2) else b"")
        out.append(Case(family, data, int(rng.choice(channels))))
    return out


def multiblock_bases() -> List[Tuple[str, bytes]]:
    """(f)'s canonical streams: (label, stream)."""
    return [("mixed 160x120 RGBA", _stream(testimages.mixed(160, 120, 4))),
            ("photo 200x90 RGB", _stream(testimages.photo(200, 90, 3))),
            ("palette_alpha 96x64", _stream(testimages.palette_alpha(96, 64)))]


def multiblock(n_mut: int = 25, n_trunc: int = 20, seed: int = 5
               ) -> List[Case]:
    """(f) n_mut mutated and n_trunc truncated streams of each of the
    three canonical streams."""
    rng = np.random.default_rng(seed)
    out = []
    for _, base in multiblock_bases():
        out += mutations("f", base, n_mut, rng)
        out += truncations("f", base, n_trunc, rng)
    return _capped(out)


def card_cases(bases: Sequence[bytes], n_mut: int = 8, n_trunc: int = 8,
               seed: int = 7) -> List[Case]:
    """(f') n_mut mutated and n_trunc truncated streams of each of
    `bases` (streams of any size; no pixel cap)."""
    rng = np.random.default_rng(seed)
    out = []
    for base in bases:
        out += mutations("f'", base, n_mut, rng)
        out += truncations("f'", base, n_trunc, rng)
    return out


#: (g)'s image classes: name -> (make(w, h, ch, seed), RGBA only)
_CLASSES: Dict[str, Tuple[Callable, bool]] = {
    "noise": (lambda w, h, c, s: testimages.noise(w, h, c, seed=s), False),
    "flat": (lambda w, h, c, s: testimages.flat(w, h, c), False),
    "gradient": (lambda w, h, c, s: testimages.gradient(w, h, c), False),
    "palette": (lambda w, h, c, s: testimages.palette(w, h, c, seed=s),
                False),
    "mixed": (lambda w, h, c, s: testimages.mixed(w, h, c, seed=s), False),
    "photo": (lambda w, h, c, s: testimages.photo(w, h, c, seed=s), False),
    "palette_collide": (lambda w, h, c, s: testimages.palette_collide(
        w, h, c, seed=s, slot=s % 64), False),
    "runs_with_caps": (lambda w, h, c, s: testimages.runs_with_caps(w, h, c),
                       False),
    "seed_run_start": (lambda w, h, c, s: testimages.seed_run_start(w, h, c),
                       False),
    "wraparound": (lambda w, h, c, s: testimages.wraparound(w, h, c), False),
    "alpha_toggle": (lambda w, h, c, s: testimages.alpha_toggle(w, h, seed=s),
                     True),
    "palette_alpha": (lambda w, h, c, s: testimages.palette_alpha(
        w, h, seed=s), True),
}


def _shape(kind: str, rng) -> Tuple[int, int]:
    if kind == "1xN":
        return 1, int(rng.integers(1, 3000))
    if kind == "Nx1":
        return int(rng.integers(1, 3000)), 1
    if kind == "under a block":
        w = int(rng.integers(1, 64))
        return w, int(rng.integers(1, 1024 // w + 1)) if w > 1 else 1023
    if kind == "near 1024k":
        h = int(rng.choice([1, 2, 4, 8, 16, 32]))
        w = 1024 * int(rng.integers(1, 5)) // h + int(rng.integers(-1, 2))
        return w, h
    return int(rng.integers(1, 400)), int(rng.integers(1, 300))


_KINDS = ("1xN", "Nx1", "under a block", "near 1024k", "any")


def encode_images(n: int = 30, seed: int = 6
                  ) -> List[Tuple[str, np.ndarray]]:
    """(g) n (label, image) pairs: shape kinds in turn, a random class and
    channel count (4 for the alpha classes), a random generator seed."""
    rng = np.random.default_rng(seed)
    names = sorted(_CLASSES)
    out = []
    for i in range(n):
        kind = _KINDS[i % len(_KINDS)]
        w, h = _shape(kind, rng)
        name = names[int(rng.integers(0, len(names)))]
        make, rgba = _CLASSES[name]
        ch = 4 if rgba else int(rng.choice([3, 4]))
        img = make(w, h, ch, int(rng.integers(0, 1000)))
        out.append((f"{name} {w}x{h}x{ch} ({kind})", img))
    return out


def _image_cases(images: Sequence[Tuple[str, np.ndarray]]) -> List[Case]:
    """(g)'s decode cases: the oracle's stream of each image."""
    return [Case("g", _stream(img)) for _, img in images]


def families(full: bool = True) -> Dict[str, List[Case]]:
    """Every decode family (a)-(g) at its full count, or (full=False) the
    quick subset: (f) at 3 mutated and 2 truncated streams of each base
    image, (g) at 10 images."""
    return {
        "a": random_bytes(), "b": valid_header_random_body(),
        "c": mutated_canonical(), "d": bad_headers(), "e": bad_channels(),
        "f": multiblock() if full else multiblock(3, 2),
        "g": _image_cases(encode_images(30 if full else 10)),
    }


# ---------------------------------------------------------------------------
# The paths and the verdict
# ---------------------------------------------------------------------------

def oracle_answer(case: Case):
    """The oracle's (pixels, desc), or None where it rejects."""
    try:
        return oracle.decode(case.data, case.channels)
    except ValueError:
        return None


@contextlib.contextmanager
def native_hidden():
    """Hide the native decoder from the decode ladder (oracle.available
    reads False), so that the ladder runs v1 and, below it, the
    sequential codec on the device."""
    saved = oracle.available
    oracle.available = lambda: False
    try:
        yield
    finally:
        oracle.available = saved


def _outcome(fn):
    """("ok", pixels, desc), ("reject", message) for a ValueError, or
    ("error", message) for any other exception: a failure."""
    try:
        img, desc = fn()
        return "ok", img, desc
    except ValueError as e:
        return "reject", str(e)
    except Exception as e:  # noqa: BLE001 -- a CUDA error, IndexError, ...
        return "error", f"{type(e).__name__}: {e}"


def _facade(case, dev):
    import qoi_tpu_torch
    return qoi_tpu_torch.decode(case.data, case.channels, device=dev)


def _ladder_no_native(case, dev):
    with native_hidden():
        return _facade(case, dev)


def _v1(case, dev):
    from ..models import decode_pipeline
    return decode_pipeline.decode(case.data, case.channels, dev)


def _scan(case, dev):
    from ..models import scan_codec
    return scan_codec.decode(case.data, case.channels, dev)


def _streamed(case, dev):
    from ..models import streamed
    return streamed.decode(case.data, case.channels, dev, tile_bytes=256)


_SINGLE = {"P1 facade": _facade, "P2 ladder without native": _ladder_no_native,
           "P3 v1": _v1, "P4 scan": _scan, "P5 streamed": _streamed}

#: the decode paths a public entry reaches (models/decode_v2 is reached by
#: none: not fuzzed)
DECODE_PATHS = tuple(_SINGLE) + ("P6 batch",)


def _batch_outcomes(cases: Sequence[Case], dev) -> list:
    """decode_batch over the cases, one call for each channels value: a
    per-stream error is a rejection; a ValueError of the whole call (a bad
    channels value) rejects every stream of the call."""
    from ..models import batch

    out = [None] * len(cases)
    by_ch: Dict[int, List[int]] = {}
    for i, c in enumerate(cases):
        by_ch.setdefault(c.channels, []).append(i)
    for ch, idxs in by_ch.items():
        try:
            res = batch.decode_batch([cases[i].data for i in idxs], ch,
                                     device=dev)
        except ValueError as e:
            res = [(None, None, str(e))] * len(idxs)
        except Exception as e:  # noqa: BLE001 -- a failure of every stream
            for i in idxs:
                out[i] = ("error", f"{type(e).__name__}: {e}")
            continue
        for i, (img, desc, err) in zip(idxs, res):
            out[i] = ("reject", err) if err is not None else ("ok", img, desc)
    return out


def decode_outcomes(path: str, cases: Sequence[Case], device) -> list:
    """The outcome of each case through one of DECODE_PATHS on `device`."""
    if path == "P6 batch":
        return _batch_outcomes(cases, device)
    fn = _SINGLE[path]
    return [_outcome(lambda c=c: fn(c, device)) for c in cases]


def problem(want, got) -> Optional[str]:
    """None where the outcome `got` agrees with the oracle's answer
    `want` (oracle_answer), else what is wrong."""
    if got[0] == "error":
        return f"raised {got[1]}"
    if want is None:
        return None if got[0] == "reject" else \
            "accepted a stream the oracle rejects"
    if got[0] == "reject":
        return f"rejected a stream the oracle accepts ({got[1]})"
    img, desc = got[1], got[2]
    if img.shape != want[0].shape or not np.array_equal(img, want[0]):
        return "pixels differ from the oracle's"
    if desc != want[1]:
        return f"descriptor {desc} differs from the oracle's {want[1]}"
    return None


def check_decode(path: str, cases: Sequence[Case], device,
                 wants=None) -> List[str]:
    """Every disagreement of `path` with the oracle over `cases`, as
    lines; `wants` are the oracle's answers where the caller has them."""
    if wants is None:
        wants = [oracle_answer(c) for c in cases]
    got = decode_outcomes(path, cases, device)
    return [f"{path}, family {c.family} case {i} ({len(c.data)} B, "
            f"channels {c.channels}): {p}"
            for i, (c, w, g) in enumerate(zip(cases, wants, got))
            if (p := problem(w, g)) is not None]


def _dense_outcome(case: Case, device):
    """decode_v3._decode_device(dense=True) on a stream the oracle accepts:
    (converged, (h, w, ch) pixels as the facade would cut them) -- pixels
    None when the fixpoint does not converge (the facade's ladder takes
    such a stream)."""
    import torch

    from ..models import decode_pipeline, decode_v3

    desc = fmt.unpack_header(case.data)
    body = np.frombuffer(case.data, np.uint8)[fmt.HEADER_SIZE:]
    pad = np.zeros(decode_pipeline.bucket_size_fine(len(body)), np.uint8)
    pad[:len(body)] = body
    px32, conv, _ = decode_v3._decode_device(
        torch.from_numpy(pad).to(device),
        len(case.data) - fmt.HEADER_SIZE - fmt.TRAILER_SIZE,
        decode_pipeline.bucket_size(desc.num_pixels), dense=True)
    if not conv:
        return False, None
    out_ch = case.channels or desc.channels
    img = decode_v3.unpack_px32(px32[:desc.num_pixels].cpu().numpy())
    return True, img[:, :out_ch].reshape(desc.height, desc.width, out_ch)


def check_dense(cases: Sequence[Case], device, wants=None
                ) -> Tuple[List[str], int]:
    """`_dense_outcome` over the cases the oracle accepts: (every converged
    decode whose pixels are not the oracle's, or that raises, as lines;
    the number that converged)."""
    if wants is None:
        wants = [oracle_answer(c) for c in cases]
    problems, n_conv = [], 0
    for i, (c, w) in enumerate(zip(cases, wants)):
        if w is None:
            continue
        try:
            conv, img = _dense_outcome(c, device)
        except Exception as e:  # noqa: BLE001 -- reported as a failure
            problems.append(f"dense, family {c.family} case {i}: raised "
                            f"{type(e).__name__}: {e}")
            continue
        n_conv += conv
        if conv and not np.array_equal(img, w[0]):
            problems.append(f"dense, family {c.family} case {i} "
                            f"({len(c.data)} B, channels {c.channels}): "
                            "converged to pixels other than the oracle's")
    return problems, n_conv


# ---------------------------------------------------------------------------
# The encode paths of (g)
# ---------------------------------------------------------------------------

def _fetch(desc, buf, tot) -> bytes:
    return (fmt.pack_header(desc) + buf[:int(tot)].cpu().numpy().tobytes()
            + fmt.TRAILER)


def _px4(img, desc, n_pad: int, device):
    import torch

    from ..models import pipeline

    px4 = np.zeros((n_pad, 4), np.uint8)
    px4[:desc.num_pixels] = pipeline.force_rgba(img, desc)
    return torch.from_numpy(px4).to(device)


def _enc_facade(img, desc, dev):
    import qoi_tpu_torch
    return qoi_tpu_torch.encode(img, desc, device=dev)


def _enc_pack(img, desc, dev):
    from ..models import decode_pipeline, pipeline
    n = desc.num_pixels
    return _fetch(desc, *pipeline.encode_device_pack(
        _px4(img, desc, decode_pipeline.bucket_size(n), dev), n))


def _enc_staging(img, desc, dev):
    """encode_stage_pallas, packed by compact_bytes6_pack as chip_smoke.py's
    path 3 runs it, with N padded to a multiple of 1024 pixels (the
    kernel's block) up to 4096 and of 4096 above (the pack's densify
    segment)."""
    from ..kernels import encode_stage, pack
    n = desc.num_pixels
    step = 1024 if n <= 4096 else 4096
    n_pad = -(-n // step) * step
    stag, lens = encode_stage.encode_stage_pallas(
        _px4(img, desc, n_pad, dev), n)
    return _fetch(desc, *pack.compact_bytes6_pack(
        stag.T.contiguous(), lens[:, 0], n_pad * 6))


def _enc_scan(img, desc, dev):
    import qoi_tpu_torch
    return qoi_tpu_torch.encode(img, desc, engine="scan", device=dev)


_ENC_SINGLE = {"facade": _enc_facade, "encode_device_pack": _enc_pack,
               "fused staging": _enc_staging, 'engine="scan"': _enc_scan}

#: the encode paths of (g)
ENCODE_PATHS = tuple(_ENC_SINGLE) + ("encode_batch",)


def check_encode(path: str, images: Sequence[Tuple[str, np.ndarray]],
                 device) -> List[str]:
    """Every image whose stream through `path` on `device` is not the
    oracle's bytes (or that raises), as lines."""
    descs = [fmt.StreamDesc(im.shape[1], im.shape[0], im.shape[2])
             for _, im in images]
    wants = [oracle.encode(im, d) for (_, im), d in zip(images, descs)]
    if path == "encode_batch":
        from ..models import batch
        try:
            got = batch.encode_batch([im for _, im in images], descs,
                                     device=device)
        except Exception as e:  # noqa: BLE001 -- reported as a failure
            return [f"encode_batch raised {type(e).__name__}: {e}"]
    else:
        got = []
        for (_, im), d in zip(images, descs):
            try:
                got.append(_ENC_SINGLE[path](im, d, device))
            except Exception as e:  # noqa: BLE001 -- reported as a failure
                got.append(f"raised {type(e).__name__}: {e}")
    return [f"{path}, {label}: " + (g if isinstance(g, str)
                                     else "not the oracle's bytes")
            for (label, _), g, w in zip(images, got, wants) if g != w]
