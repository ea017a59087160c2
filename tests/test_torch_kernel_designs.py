"""The algebra of the decode kernels' designs, on the CPU.

The CUDA kernels of qoi_tpu_torch/csrc/block_maps.cu and csrc/expand.cu
run only on the card, where tests/test_torch_kernels_gpu.py holds them
against their twins. Here the algebra each design rests on is held,
exactly (tolerance 0, an integer codec), against the port's plain twins
and the JAX package:

- block_maps: a lane cut into S segments, each walked from the identity
  state, with the segment maps composed by prefix (E_0 = identity,
  E_{j+1} = E_j o M_j) and each segment's per-position px entries mapped
  through its E_j, equals the walk of the whole lane;
- expand: filling each byte's pixel range [pix_off[i], pix_off[i+1])
  (the last byte up to n_px_cap, the seed before the first byte) equals
  the telescoping-sum expand.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

from qoi_tpu.kernels import expand as jexpand
from qoi_tpu.models import decode_v3 as jd3
from qoi_tpu.utils import testimages
from qoi_tpu_torch import format as fmt
from qoi_tpu_torch import oracle
from qoi_tpu_torch._bits import to_i32
from qoi_tpu_torch.kernels import block_maps as tbm
from qoi_tpu_torch.kernels import expand as texpand
from qoi_tpu_torch.models import decode_pipeline
from qoi_tpu_torch.models import decode_v3 as td3
from torch_testutil import as_u32, assert_same, to_torch

needs_oracle = pytest.mark.skipif(not oracle.available(),
                                  reason="oracle not built")

_ABS = 0x41


def _through(er, ev, r, v):
    """Map entries (r, v) ((k, nb) u32) through the prefix map (er, ev)
    ((65, nb) u32), per channel: root 0x41 stays (0x41, val), any other
    root gives (er[root], ev[root] + val mod 256)."""
    out_r, out_v = np.zeros_like(r), np.zeros_like(v)
    for c in (0, 8, 16, 24):
        rc, vc = (r >> c) & 0xFF, (v >> c) & 0xFF
        idx = np.minimum(rc, 64)
        lr = (np.take_along_axis(er, idx, 0) >> c) & 0xFF
        lv = (np.take_along_axis(ev, idx, 0) >> c) & 0xFF
        absolute = rc == _ABS
        out_r |= np.where(absolute, _ABS, lr) << c
        out_v |= np.where(absolute, vc, (lv + vc) & 0xFF) << c
    return out_r, out_v


def _segmented_block_maps(meta, d32, lit32, segs):
    """Pass 1 as the kernel computes it: walk, compose, fix up. Segments
    are ceil(b / segs) long, the last ones shorter or empty."""
    b, nb = meta.shape
    seg_len = -(-b // segs)
    er = np.repeat((np.arange(65, dtype=np.int64) * 0x01010101)[:, None],
                   nb, axis=1)
    ev = np.zeros((65, nb), np.int64)
    proot, pval = [], []
    for j in range(segs):
        i0, i1 = min(b, j * seg_len), min(b, (j + 1) * seg_len)
        mr, mv, pr, pv = (as_u32(x) for x in tbm.block_maps_plain(
            meta[i0:i1], d32[i0:i1], lit32[i0:i1]))
        pr, pv = _through(er, ev, pr, pv)
        proot.append(pr)
        pval.append(pv)
        er, ev = _through(er, ev, mr, mv)
    return er, ev, np.concatenate(proot), np.concatenate(pval)


# the JAX side runs compiled: eagerly its scans take seconds
_fields_jit = jax.jit(jd3._fields)
_initial_w_jit = jax.jit(jd3._initial_w)
_block_maps_jit = jax.jit(lambda meta, d32, lit32, nb, b: jd3._block_maps(
    meta, d32, lit32, nb, b, emit_px=True), static_argnums=(3, 4))


def _jax_block_maps(meta, d32, lit32):
    b, nb = meta.shape
    return _block_maps_jit(jnp.asarray(meta),
                           jnp.asarray(d32.view(np.uint32)),
                           jnp.asarray(lit32.view(np.uint32)), nb, b)


def _stream_planes(img):
    """Position-major pass-1 planes (meta from the initial w, d32, lit32)
    of an image's stream, built by the JAX package as
    tests/test_torch_decode.py builds them."""
    h, w, ch = img.shape
    stream = oracle.encode(img, fmt.StreamDesc(w, h, ch))
    raw = np.frombuffer(stream, np.uint8)[fmt.HEADER_SIZE:]
    pad = np.zeros(decode_pipeline.bucket_size(len(raw)), np.uint8)
    pad[: len(raw)] = raw
    starts, cls, r6, d32, lit32, npix = (np.asarray(x) for x in _fields_jit(
        jnp.asarray(pad), jnp.int32(len(stream) - 22)))
    w0, _ = _initial_w_jit(jnp.asarray(cls), jnp.asarray(r6),
                           jnp.asarray(d32), jnp.asarray(lit32),
                           npix=jnp.asarray(npix))
    w0 = np.where(starts, np.asarray(w0), 0)
    m = pad.shape[0]
    b = jd3._scan_block_len(m)
    pm = lambda x: np.ascontiguousarray(x.reshape(m // b, b).T)
    return (pm((cls | (r6 << 9) | (w0 << 3)).astype(np.int32)),
            pm(d32).view(np.int32), pm(lit32).view(np.int32))


def _random_planes():
    """b = 96, nb = 13: every class, most chunks INDEX or RGB on four
    slots, so INDEX chains and RGB alpha flows cross every segment
    edge."""
    rng = np.random.default_rng(11)
    b, nb = 96, 13
    cls = rng.choice(5, (b, nb), p=[0.1, 0.2, 0.25, 0.1, 0.35])
    meta = (cls | rng.integers(0, 4, (b, nb)) << 3).astype(np.int32)
    d32, lit32 = (rng.integers(-2**31, 2**31, (b, nb)).astype(np.int32)
                  for _ in range(2))
    return meta, d32, lit32


@pytest.fixture(scope="module")
def pass1_cases():
    """Inputs and JAX pass-1 outputs per case."""
    out = {}
    for case, make in (("random", _random_planes),
                       ("mixed",
                        lambda: _stream_planes(testimages.mixed(96, 64, 4))),
                       ("palette_alpha", lambda: _stream_planes(
                           testimages.palette_alpha(80, 48, colors=40)))):
        if case != "random" and not oracle.available():
            continue
        planes = make()
        out[case] = (planes, tuple(np.asarray(x)
                                   for x in _jax_block_maps(*planes)))
    return out


@pytest.mark.parametrize("segs", [1, 2, 5, 12, 32, 128])
@pytest.mark.parametrize("case", [
    "random",
    pytest.param("mixed", marks=needs_oracle),
    pytest.param("palette_alpha", marks=needs_oracle)])
def test_segmented_block_maps_equal_whole_walk(pass1_cases, case, segs):
    """S = 12 is the kernel's. S = 5 and 12 leave b
    (96, or the streams' power of two) not a multiple of S; S = 128
    leaves segments empty."""
    planes, want_jax = pass1_cases[case]
    whole = tbm.block_maps_plain(*(to_torch(x) for x in planes))
    got = _segmented_block_maps(*(to_torch(x) for x in planes), segs)
    for g, w_plain, w_jax in zip(got, whole, want_jax):
        assert_same(w_plain, g)
        assert_same(w_jax, g)


def _fill(pix_off, px32, n_px_cap):
    """The direct fill: byte i writes px32[i] to [pix_off[i], pix_off[i+1])
    (the last byte up to n_px_cap), both ends clamped to [0, n_px_cap];
    pixels before pix_off[0] take the seed. The ranges must tile the
    plane: each word is written exactly once."""
    out = np.full(n_px_cap, texpand._SEED32, np.int64)
    if len(pix_off) == 0:
        return out
    lo = np.clip(pix_off.astype(np.int64), 0, n_px_cap)
    hi = np.r_[lo[1:], n_px_cap]
    assert (hi >= lo).all()
    out[lo[0]:] = np.repeat(px32.astype(np.int64) & 0xFFFFFFFF, hi - lo)
    return out


def _runs(m, seed, first=0):
    """Random per-byte (pix_off, px32) with chunks of 1, 2, 4 or 5 bytes
    and runs of up to 62 pixels, starting at pixel `first`."""
    rng = np.random.default_rng(seed)
    npix = np.zeros(m, np.int64)
    px = np.zeros(m, np.uint32)
    i = 0
    while i < m:
        nbytes = int(rng.choice([1, 2, 4, 5]))
        npix[i] = int(rng.integers(1, 63)) if nbytes == 1 else 1
        px[i:i + nbytes] = np.uint32(rng.integers(0, 2**32))
        i += nbytes
    pix_off = first + np.cumsum(npix) - npix
    return pix_off.astype(np.int32), px.view(np.int32)


def _stream_records(dense):
    """(pix_off, px32, n_px_cap) of a decoded stream with a long padded
    tail: per byte, or the dense records of `_compact_chunks` (_INF
    tail)."""
    img = testimages.palette_alpha(80, 48, colors=40)
    stream = oracle.encode(img, fmt.StreamDesc(80, 48, 4))
    raw = np.frombuffer(stream, np.uint8)[fmt.HEADER_SIZE:]
    pad = np.zeros(max(decode_pipeline.bucket_size(len(raw)), 4096), np.uint8)
    pad[: len(raw)] = raw
    px, starts, _, pix_off, conv, _, _ = td3._decode_core(to_torch(pad),
                                                          len(stream) - 22)
    assert conv
    if dense:
        off, px32 = td3._compact_chunks(starts, pix_off, px)
        assert (off.numpy() == td3._INF).any()
    else:
        off, px32 = pix_off.int(), to_i32(px)
    return off.numpy(), px32.numpy(), decode_pipeline.bucket_size(80 * 48)


_FILL_CASES = {
    "shared_and_past_cap": lambda: (np.array([3, 3, 5, 9, 40, 41], np.int32),
                                    np.array([7, 7, 8, 9, 10, 11], np.int32),
                                    16),
    "empty": lambda: (np.zeros(0, np.int32), np.zeros(0, np.int32), 8),
    "first_offset_past_zero": lambda: (*_runs(3000, 1, first=700), 60000),
    "offsets_past_cap": lambda: (*_runs(3000, 2), 4000),
    "all_past_cap": lambda: (np.array([9, 12], np.int32),
                             np.array([1, 2], np.int32), 9),
    "per_byte_stream": lambda: _stream_records(dense=False),
    "dense_inf_tail": lambda: _stream_records(dense=True),
}


@pytest.mark.parametrize("case", [
    pytest.param(c, marks=needs_oracle) if "stream" in c or "dense" in c
    else c for c in _FILL_CASES])
def test_direct_fill_equals_telescoping_expand(case):
    pix_off, px32, cap = _FILL_CASES[case]()
    got = _fill(pix_off, px32, cap)
    want_t = texpand.expand_px_xla(to_torch(pix_off), to_torch(px32), cap)
    want_j = jexpand.expand_px_xla(jnp.asarray(pix_off),
                                   jnp.asarray(px32.view(np.uint32)), cap)
    assert_same(want_t, got)
    assert_same(want_j, got)
