"""qoi_tpu_torch record pack (kernels/pack.py, the splitd encode) vs the
JAX package's pack kernel in Pallas interpret mode and the C++ oracle, on
the CPU (the placement's plain twin). The same numpy inputs go to both
packages; every comparison is exact (integer bit patterns). Cases follow
the geometries of tests/test_pack_kernel.py at one size, N = 16384, so
the JAX kernel compiles once per entry point."""
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from qoi_tpu.kernels import pack as jpack
from qoi_tpu.models import pipeline as jpipe
from qoi_tpu_torch import format as fmt
from qoi_tpu_torch import oracle
from qoi_tpu_torch.kernels import pack as tpack
from qoi_tpu_torch.models import pipeline as tpipe
from qoi_tpu_torch.utils import testimages
from torch_testutil import assert_same, to_torch

N = 1 << 14

# the JAX steps under one jit each: one compile per entry point instead of
# one per eager op of the 12 densify passes
_j_densify_shift = jax.jit(jpack._densify_shift)
_j_densify_sort = jax.jit(jpack._densify_sort)
_j_prep_planes = jax.jit(jpack._prep_planes)


@functools.cache
def _j_pack(densify):
    return jax.jit(functools.partial(
        jpack.compact_bytes6_pack, capacity=N * 6, interpret=True,
        densify=densify, window="dyn"))


def _random_staging(n, rng, p_zero=0.5):
    lens = rng.choice([0, 1, 2, 3, 4, 5, 6], size=n,
                      p=[p_zero] + [(1 - p_zero) / 6] * 6)
    staging = rng.integers(0, 256, size=(6, n), dtype=np.uint8)
    return _masked(staging, lens)


def _masked(staging, lens):
    col = np.arange(6)[:, None]
    return (np.where(col < lens[None, :], staging, 0).astype(np.uint8),
            lens.astype(np.int32))


def _case(name):
    """(staging (6, N) uint8, lens (N,) int32) for one geometry."""
    rng = np.random.default_rng(sorted(CASES).index(name))
    full = rng.integers(0, 256, size=(6, N), dtype=np.uint8)
    if name == "random":
        return _random_staging(N, rng)
    lens = np.zeros(N, np.int32)
    if name == "segment_edges":       # records hugging densify-segment edges
        lens[4095], lens[4096] = 5, 6
        lens[8191], lens[8192] = 1, 1
        lens[12288:] = 6                # and a fully dense segment
    elif name == "long_zero_gaps":    # emitters thousands of pixels apart
        lens[::3000] = rng.integers(1, 7, len(lens[::3000]))
        lens[-1] = 4
    elif name == "all_six":
        lens[:] = 6
    elif name == "six_spill":         # offsets 3, 9, 15, ...: every record
        lens[:] = 6                     # spills a third word, the last one
        lens[0] = 3                     # into the sentinel slot
    elif name == "all_one":
        lens[:] = 1
    elif name.startswith("phase"):    # a lead record of 1..4 bytes moves
        staging, lens = _random_staging(N, rng, p_zero=0.3)  # every offset
        lens[0] = int(name[-1])         # through each word phase
        return _masked(staging, lens)
    # "empty": no record emits
    return _masked(full, lens)


CASES = ["random", "segment_edges", "long_zero_gaps", "all_six",
         "six_spill", "all_one", "empty", "phase1", "phase2", "phase3",
         "phase4"]


def _got(staging, lens, **kw):
    buf, tot = tpack.compact_bytes6_pack(to_torch(staging), to_torch(lens),
                                         N * 6, **kw)
    assert buf.dtype == torch.uint8 and buf.shape == (N * 6,)
    return buf.numpy(), int(tot)


@pytest.mark.parametrize("densify", ["shift", "sort"])
@pytest.mark.parametrize("case", CASES)
def test_compact_bytes6_pack_matches_jax(case, densify):
    staging, lens = _case(case)
    want, wtot = _j_pack(densify)(jnp.asarray(staging), jnp.asarray(lens))
    got, tot = _got(staging, lens, densify=densify)
    assert tot == int(wtot) == int(lens.sum())
    np.testing.assert_array_equal(got[:tot], np.asarray(want)[:tot])
    assert not got[tot:].any(), "bytes past the stream must be 0"


@pytest.mark.parametrize("case", ["random", "segment_edges", "six_spill",
                                  "empty"])
def test_densify_and_planes_match_jax(case):
    """Both densify forms and the word/contribution planes, slot by slot
    (tail records included)."""
    staging, lens = _case(case)
    js, jl = jnp.asarray(staging), jnp.asarray(lens)
    ts, tl = to_torch(staging), to_torch(lens)
    total = int(lens.sum())
    for jfn, tfn in ((_j_densify_shift, tpack._densify_shift),
                     (_j_densify_sort, tpack._densify_sort)):
        want, got = jfn(js, jl), tfn(ts, tl)
        for a, b in zip(want, got):
            assert_same(a, b)
    want = _j_prep_planes(*_j_densify_shift(js, jl)[:3], jnp.int32(total))
    got = tpack._prep_planes(*tpack._densify_shift(ts, tl)[:3], total)
    for a, b in zip(want, got):
        assert_same(a, b)


@pytest.mark.parametrize("case", ["random", "long_zero_gaps", "six_spill"])
def test_place_words_twin_matches_jax_kernel(case):
    """The placement's plain twin against the Pallas `_place_words` in
    interpret mode on the same planes, over every word of the stream. The
    JAX words come through `place_records` (its prep, then `_place_words`
    bitcast to bytes), which shares its compile with the test below."""
    staging, lens = _case(case)
    total = int(lens.sum())
    records = jpack.densify_records(jnp.asarray(staging), jnp.asarray(lens))
    wp, c0, c1 = _j_prep_planes(*records[:3], jnp.int32(total))
    wbuf, _ = jpack.place_records(*records, N * 6, interpret=True)
    want = np.asarray(wbuf).view(np.int32)
    got = tpack.place_words(to_torch(np.asarray(wp)),
                            to_torch(np.asarray(c0)),
                            to_torch(np.asarray(c1)), N * 6 // 4)
    assert got.dtype == torch.int32
    nw = -(-total // 4)
    assert_same(np.asarray(want)[:nw], got[:nw])


def test_place_records_matches_jax():
    """densify_records + place_records (the two-program public API)."""
    staging, lens = _case("random")
    want = jpack.densify_records(jnp.asarray(staging), jnp.asarray(lens))
    got = tpack.densify_records(to_torch(staging), to_torch(lens))
    for a, b in zip(want, got):
        assert_same(a, b)
    wbuf, wtot = jpack.place_records(*want, N * 6, interpret=True)
    buf, tot = tpack.place_records(*got, N * 6)
    assert int(tot) == int(wtot)
    np.testing.assert_array_equal(buf.numpy()[: int(tot)],
                                  np.asarray(wbuf)[: int(wtot)])


def _padded(img, cap):
    h, w, ch = img.shape
    px4 = tpipe.force_rgba(img, fmt.StreamDesc(w, h, ch))
    out = np.zeros((cap, 4), np.uint8)
    out[: px4.shape[0]] = px4
    return out, px4.shape[0]


def _check_pack_encode(img, cap):
    h, w, ch = img.shape
    desc = fmt.StreamDesc(w, h, ch)
    padded, n = _padded(img, cap)
    wbuf, wtot = jpipe.encode_device_pack(jnp.asarray(padded),
                                          jnp.int32(n), interpret=True)
    buf, tot = tpipe.encode_device_pack(to_torch(padded), n)
    assert int(tot) == int(wtot)
    body = buf.numpy()[: int(tot)]
    np.testing.assert_array_equal(body, np.asarray(wbuf)[: int(wtot)])
    got = fmt.pack_header(desc) + body.tobytes() + fmt.TRAILER
    assert got == oracle.encode(img, desc)


@pytest.mark.parametrize("name,ch", [
    (name, ch) for ch in (3, 4)
    for name in sorted(testimages.edge_case_suite(ch))])
def test_encode_device_pack_matches_jax_and_oracle(name, ch):
    """Every edge case, padded to 4096 pixels (one JAX compile)."""
    if not oracle.available():
        pytest.skip("oracle not built")
    _check_pack_encode(testimages.edge_case_suite(ch)[name], 4096)


def test_encode_device_pack_multi_segment():
    """Four densify segments (N = 16384) of a photo frame."""
    if not oracle.available():
        pytest.skip("oracle not built")
    _check_pack_encode(testimages.photo(160, 96, 4, seed=11), N)
