"""The CUDA kernels of qoi_tpu_torch against their plain PyTorch twins, on
the card. Results must be exactly equal (integer kernels).

These tests need a CUDA device and skip without one. The repository's
conftest imports jax, which the GPU machine need not have, so run them
there with:

    python -m pytest --noconftest -m gpu tests/test_torch_kernels_gpu.py -q
"""
import numpy as np
import pytest
import torch

import qoi_tpu_torch
from qoi_tpu import format as fmt
from qoi_tpu import oracle
from qoi_tpu.utils import testimages
from qoi_tpu_torch._bits import to_i32
from qoi_tpu_torch.kernels import _build
from qoi_tpu_torch.kernels import block_maps as kbm
from qoi_tpu_torch.kernels import expand as kexp
from qoi_tpu_torch.kernels import slide as kslide
from qoi_tpu_torch.models import buckets, decode_v3
from qoi_tpu_torch.ops import compact

pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _same(got, want):
    torch.cuda.synchronize()
    assert got.dtype == want.dtype == torch.int32
    assert got.shape == want.shape
    assert torch.equal(got.cpu(), want.cpu())


def _records(n, kind, seed):
    rng = np.random.default_rng(seed)
    if kind == "mixed":
        lens = rng.integers(0, 7, n)
    elif kind == "dense6":
        lens = np.full(n, 6)
        lens[-1] = 5
    elif kind == "sparse":
        lens = np.where(rng.random(n) < 0.05, rng.integers(1, 7, n), 0)
    else:
        lens = np.zeros(n, np.int64)
    b = rng.integers(1, 256, (n, 6)).astype(np.int64)
    b = np.where(np.arange(6)[None, :] < lens[:, None], b, 0)
    lo = b[:, 0] | b[:, 1] << 8 | b[:, 2] << 16 | b[:, 3] << 24
    hi = b[:, 4] | b[:, 5] << 8
    return (torch.from_numpy(lo), torch.from_numpy(hi),
            torch.from_numpy(lens.astype(np.int64)))


@pytest.mark.parametrize("n,kind,seg", [
    (20480 * 3 + 77, "mixed", 20480),   # ragged: padded last row
    (4096 * 2, "dense6", 4096),
    (5000, "sparse", 1024),
    (300, "empty", 4096),               # one row, no events
])
def test_slide_kernel_matches_twin(dev, n, kind, seg):
    ev = compact.wordsum_events(*(t.to(dev) for t in _records(n, kind, n)),
                                seg)
    val, aux = to_i32(ev.val), ev.aux.to(torch.int32)
    _same(kslide.slide_val(val, aux), kslide.slide_val_plain(val, aux))


@pytest.mark.parametrize("n,kind", [
    (20480 * 2 + 5, "mixed"), (4096, "dense6"), (64, "empty")])
def test_compact_on_card_matches_cpu(dev, n, kind):
    """Words and total (incl. total == 0) through the slide kernel equal
    the CPU path through the twin."""
    recs = _records(n, kind, 7 * n)
    cap = -(-n * 6 // 4) * 4
    wc, tc = compact.compact_words6_wordsum(*recs, cap, seg=20480)
    wg, tg = compact.compact_words6_wordsum(*(t.to(dev) for t in recs),
                                            cap, seg=20480)
    assert int(tg) == int(tc)
    _same(wg, wc)


def _expand_records(m, seed, max_run=62):
    rng = np.random.default_rng(seed)
    npix = np.zeros(m, np.int64)
    px = np.zeros(m, np.uint32)
    i = 0
    while i < m:
        nbytes = int(rng.choice([1, 2, 4, 5]))
        npix[i] = int(rng.integers(1, max_run + 1)) if nbytes == 1 else 1
        px[i:i + nbytes] = np.uint32(rng.integers(0, 2**32))
        i += nbytes
    pix_off = (np.cumsum(npix) - npix).astype(np.int32)
    return torch.from_numpy(pix_off), torch.from_numpy(px.view(np.int32))


@pytest.mark.parametrize("m,cap,seed,max_run", [
    (600, 512, 0, 62),          # truncation: offsets overflow the cap
    (100, 2048, 2, 62),         # tail repeats the last chunk's px
    (70000, 65536, 3, 62),
    (200000, 262144, 4, 1),     # no runs: every chunk one pixel
])
def test_expand_kernel_matches_twin(dev, m, cap, seed, max_run):
    pix_off, px = (t.to(dev) for t in _expand_records(m, seed, max_run))
    _same(kexp.expand_px(pix_off, px, cap),
          kexp.expand_px_xla(pix_off, px, cap))


def test_expand_kernel_empty_stream(dev):
    z = torch.zeros(0, dtype=torch.int32, device=dev)
    _same(kexp.expand_px(z, z, 100), kexp.expand_px_xla(z, z, 100))


def _stream_planes(img, dev):
    h, w, ch = img.shape
    s = oracle.encode(img, fmt.StreamDesc(w, h, ch))
    raw = np.frombuffer(s, np.uint8)[fmt.HEADER_SIZE:]
    m = buckets.bucket_size(len(raw))
    pad = np.zeros(m, np.uint8)
    pad[: len(raw)] = raw
    b = decode_v3._scan_block_len(m)
    starts, cls, r6, d32, lit32, npix = decode_v3._fields(
        torch.from_numpy(pad).to(dev), len(s) - 22)
    w0, _ = decode_v3._initial_w(cls, r6, d32, lit32, npix)
    w0 = torch.where(starts, w0, 0)
    pm = lambda x: decode_v3._pos_major(x, m, b)
    return (pm((cls | (r6 << 9) | (w0 << 3)).to(torch.int32)),
            pm(to_i32(d32)), pm(to_i32(lit32)))


@pytest.mark.parametrize("case", ["mixed", "palette_alpha", "random"])
def test_block_maps_kernel_matches_twin(dev, case):
    if case == "random":   # every class, random slots; nb not a multiple of 64
        rng = np.random.default_rng(1)
        b, nb = 96, 77
        cls = rng.integers(0, 5, (b, nb))
        meta = torch.from_numpy(
            (cls | rng.integers(0, 64, (b, nb)) << 3).astype(np.int32))
        d32, lit32 = (torch.from_numpy(rng.integers(
            -2**31, 2**31, (b, nb)).astype(np.int32)) for _ in range(2))
        planes = (meta.to(dev), d32.to(dev), lit32.to(dev))
    else:
        img = (testimages.mixed(200, 120, 4) if case == "mixed"
               else testimages.palette_alpha(160, 90))
        planes = _stream_planes(img, dev)
    for got, want in zip(kbm.block_maps(*planes),
                         kbm.block_maps_plain(*planes)):
        _same(got, want)


def test_wrappers_count_launches(dev):
    _build.reset_launches()
    z = torch.zeros((2, 8), dtype=torch.int32, device=dev)
    kslide.slide_val(z, z)
    kexp.expand_px(z[0], z[0], 4)
    kbm.block_maps(z, z, z)
    torch.cuda.synchronize()
    assert _build.launches == {"slide_val": 1, "expand_px": 1,
                               "block_maps": 1}


@pytest.mark.parametrize("ch", [3, 4])
def test_codec_on_card_matches_oracle(dev, ch):
    for name, img in testimages.edge_case_suite(ch).items():
        h, w = img.shape[:2]
        want = oracle.encode(img, fmt.StreamDesc(w, h, ch))
        assert qoi_tpu_torch.encode(img, device=dev) == want, name
        got, _ = qoi_tpu_torch.decode(want, device=dev)
        np.testing.assert_array_equal(got, oracle.decode(want)[0], name)
