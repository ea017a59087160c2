"""qoi_tpu_torch encode path vs the JAX package and the C++ oracle, on the
CPU (the kernels' plain twins). Every stage gets the same numpy inputs in
both packages; the tolerance is exact equality everywhere (an integer
codec)."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import qoi_tpu_torch
from qoi_tpu import format as fmt
from qoi_tpu import oracle
from qoi_tpu.kernels import slide as jslide
from qoi_tpu.models import pipeline as jpipe
from qoi_tpu.ops import compact as jcompact
from qoi_tpu.ops import scans as jscans
from qoi_tpu.ops import table as jtable
from qoi_tpu.utils import testimages
from qoi_tpu_torch.kernels import slide as tslide
from qoi_tpu_torch.models import pipeline as tpipe
from qoi_tpu_torch.ops import compact as tcompact
from qoi_tpu_torch.ops import scans as tscans
from qoi_tpu_torch.ops import table as ttable
from torch_testutil import (as_u32, assert_same, e2e_cases, e2e_image,
                            oracle_built, to_torch)

pytestmark = pytest.mark.usefixtures("oracle_built")


def _px4(img):
    h, w, ch = img.shape
    return tpipe.force_rgba(img, fmt.StreamDesc(w, h, ch))


@pytest.fixture(scope="module")
def images():
    """Small images covering every op class, as (N, 4) uint8 padded to a
    bucket with the valid count."""
    out = {}
    for name, img in [("mixed", testimages.mixed(96, 40, 4, seed=3)),
                      ("palette_alpha", testimages.palette_alpha(64, 40)),
                      ("runs", testimages.runs_with_caps(130, 20, 4))]:
        px4 = _px4(img)
        n = px4.shape[0]
        padded = np.zeros((tpipe.bucket_size(n), 4), np.uint8)
        padded[:n] = px4
        out[name] = (padded, n)
    return out


@pytest.mark.parametrize("variant", ["plain", "run_in", "last_pos", "both"])
def test_run_segmentation_matches_jax(variant):
    rng = np.random.default_rng(5)
    eq = rng.random(700) < 0.93   # long runs straddling the 62-cap
    eq[300:480] = True
    run_in = 37 if variant in ("run_in", "both") else None
    last_pos = 611 if variant in ("last_pos", "both") else None
    want = jscans.run_segmentation(jnp.asarray(eq), last_pos=last_pos,
                                   run_in=run_in)
    got = tscans.run_segmentation(to_torch(eq), last_pos=last_pos,
                                  run_in=run_in)
    for a, b in zip(want, got):
        assert_same(a, b)


@pytest.mark.parametrize("incoming", [False, True])
@pytest.mark.parametrize("case", ["mixed", "palette_alpha"])
def test_table_hit_matches_jax(images, case, incoming):
    padded, n = images[case]
    rng = np.random.default_rng(9)
    eq = np.asarray(jpipe._prep_eq(jnp.asarray(padded), jnp.int32(n)))
    inc = None
    if incoming:
        inc = (rng.integers(0, 1 << 32, 64, dtype=np.uint64).astype(np.uint32),
               rng.random(64) < 0.5)
    keys = jtable.hash64(jnp.asarray(padded))
    vals = jtable.pack_rgba(jnp.asarray(padded))
    hit_j, (tab_j, wr_j) = jtable.table_hit(
        keys, vals, jnp.asarray(~eq),
        incoming=None if inc is None else (jnp.asarray(inc[0]),
                                           jnp.asarray(inc[1])))
    hit_t, (tab_t, wr_t) = ttable.table_hit(
        ttable.hash64(to_torch(padded)), ttable.pack_rgba(to_torch(padded)),
        to_torch(~eq),
        incoming=None if inc is None else (to_torch(inc[0].astype(np.int64)),
                                           to_torch(inc[1])))
    assert_same(hit_j, hit_t)
    assert_same(tab_j, tab_t)
    assert_same(wr_j, wr_t)


def _carry_in(kind):
    """(JAX kwargs, port kwargs) for the incoming tile carry."""
    if kind == "seed":
        return {}, {}
    rng = np.random.default_rng(17)
    prev = np.array([12, 200, 7, 255], np.uint8)
    tbl = rng.integers(0, 1 << 32, 64, dtype=np.uint64).astype(np.uint32)
    wr = rng.random(64) < 0.6
    run_in = 23
    jk = dict(prev_in=jnp.asarray(prev), run_in=jnp.int32(run_in),
              table_in=(jnp.asarray(tbl), jnp.asarray(wr)),
              contains_last=jnp.bool_(kind == "carry_last"))
    tk = dict(prev_in=to_torch(prev), run_in=run_in,
              table_in=(to_torch(tbl.astype(np.int64)), to_torch(wr)),
              contains_last=kind == "carry_last")
    return jk, tk


@pytest.mark.parametrize("carry", ["seed", "carry_mid", "carry_last"])
@pytest.mark.parametrize("case", ["mixed", "palette_alpha", "runs"])
def test_encode_stage_chunks_words_matches_jax(images, case, carry):
    padded, n = images[case]
    jk, tk = _carry_in(carry)
    want = jpipe.encode_stage_chunks(jnp.asarray(padded), jnp.int32(n),
                                     form="words", **jk)
    got = tpipe.encode_stage_chunks(to_torch(padded), n, **tk)
    assert_same(want.lo, got.lo)
    assert_same(want.hi, got.hi)
    assert_same(want.lens, got.lens)
    for a, b in zip(want.carry, got.carry):
        assert_same(a, b)


@pytest.fixture(scope="module")
def records(images):
    """Record words of the mixed image from the JAX stages (numpy)."""
    padded, n = images["mixed"]
    ch = jpipe.encode_stage_chunks(jnp.asarray(padded), jnp.int32(n),
                                   form="words")
    return (np.asarray(ch.lo), np.asarray(ch.hi), np.asarray(ch.lens))


@pytest.mark.parametrize("seg", [512, 4096])
def test_wordsum_events_matches_jax(records, seg):
    lo, hi, lens = records
    want = jcompact._wordsum_events_words(
        jnp.asarray(lo), jnp.asarray(hi), jnp.asarray(lens), seg)
    got = tcompact._wordsum_events_words(
        to_torch(lo.astype(np.int64)), to_torch(hi.astype(np.int64)),
        to_torch(lens), seg)
    assert len(want) == len(got)
    for a, b in zip(want, got):
        assert_same(a, b)


@pytest.mark.parametrize("seg", [512, 1024])
def test_slide_twin_matches_jax_slide_and_pallas_interpret(records, seg):
    """The plain twin of kernel A against the XLA slide AND the Pallas
    slide kernel in interpret mode, over the whole plane: dead slots
    (beyond each row's events) must come out 0 in all three."""
    lo, hi, lens = records
    val, aux = jcompact._wordsum_events_words(
        jnp.asarray(lo), jnp.asarray(hi), jnp.asarray(lens), seg)[:2]
    want_xla, _ = jcompact._wordsum_slide(val, aux)
    want_pl = jslide.slide_val(val, aux, interpret=True)
    got = tslide.slide_val(to_torch(np.asarray(val).view(np.int32)),
                           to_torch(np.asarray(aux)))
    assert got.dtype == torch.int32
    assert_same(want_xla, got)
    assert_same(want_pl, got)
    # dead slots exist here and are all zero
    cnt = (np.asarray(aux) & 1).sum(axis=1)
    assert (cnt < val.shape[1]).all()
    dead = np.arange(val.shape[1])[None, :] >= cnt[:, None]
    assert not as_u32(got)[dead].any()


@pytest.mark.parametrize("n,lens_kind", [
    (4096 * 3, "mixed"), (4096 * 2 + 100, "dense6"), (512, "sparse"),
    (64, "empty")])
def test_compact_words6_wordsum_matches_jax(n, lens_kind):
    """Words and total across segment geometries (multi-segment, ragged
    padding, one segment) and length regimes, incl. a final partial word
    and total == 0."""
    rng = np.random.default_rng(n + len(lens_kind))
    if lens_kind == "mixed":
        lens = rng.integers(0, 7, n)
    elif lens_kind == "dense6":
        lens = np.full(n, 6)
        lens[-1] = 5
    elif lens_kind == "sparse":
        lens = np.where(rng.random(n) < 0.05, rng.integers(1, 7, n), 0)
    else:
        lens = np.zeros(n, np.int64)
    lens = lens.astype(np.int32)
    b = rng.integers(1, 256, (n, 6)).astype(np.uint64)
    b = np.where(np.arange(6)[None, :] < lens[:, None], b, 0)
    lo = (b[:, 0] | b[:, 1] << 8 | b[:, 2] << 16
          | b[:, 3] << 24).astype(np.uint32)
    hi = (b[:, 4] | b[:, 5] << 8).astype(np.uint32)
    cap = n * 6
    ww, tw = jcompact.compact_words6_wordsum(
        jnp.asarray(lo), jnp.asarray(hi), jnp.asarray(lens), cap,
        seg=4096, words_out=True)
    wt, tt = tcompact.compact_words6_wordsum(
        to_torch(lo.astype(np.int64)), to_torch(hi.astype(np.int64)),
        to_torch(lens), cap,
        seg=4096)
    assert int(tw) == int(tt) == int(lens.sum())
    assert_same(ww, wt)


def test_encode_device_wordsum_matches_jax(images):
    padded, n = images["mixed"]
    ww, tw = jpipe.encode_device_wordsum(jnp.asarray(padded), jnp.int32(n),
                                         seg=1024)
    wt, tt = tpipe.encode_device_wordsum(to_torch(padded), n, seg=1024)
    assert int(tw) == int(tt)
    assert_same(np.asarray(ww)[: -(-int(tw) // 4)],
                 wt[: -(-int(tt) // 4)])


@pytest.mark.parametrize("name,ch", e2e_cases())
def test_encode_matches_oracle(name, ch):
    img = e2e_image(name, ch)
    h, w = img.shape[:2]
    want = oracle.encode(img, fmt.StreamDesc(w, h, ch))
    assert qoi_tpu_torch.encode(img, device="cpu") == want


def test_encode_above_stream_threshold_raises():
    """Above STREAM_THRESHOLD_PX the facade streams tile by tile
    (tests/test_torch_streamed.py); the streamed encoder still refuses a
    pixel buffer that does not match the descriptor, and a descriptor
    past the format's cap."""
    desc = fmt.StreamDesc(8192, 4096, 4)
    assert desc.num_pixels > qoi_tpu_torch.STREAM_THRESHOLD_PX
    with pytest.raises(ValueError, match="pixel count"):
        qoi_tpu_torch.encode(np.zeros((1, 1, 4), np.uint8), desc,
                             device="cpu")
    with pytest.raises(ValueError, match="reference pixel-count guard"):
        qoi_tpu_torch.encode(np.zeros((1, 1, 4), np.uint8),
                             fmt.StreamDesc(25600, 15625, 4), device="cpu")
