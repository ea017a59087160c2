"""The differential fuzz on the card: tests/test_torch_fuzz.py's families
(a)-(g) at their full counts and the same seeds on `device="cuda"`, and
the card-sized family (f'): 8 mutated and 8 truncated streams each of a
4K `mixed` and a 4K `photo` frame through the facade, the ladder without
the native decoder and `_decode_device(dense=True)`, and 8 mutated 256x256
streams through every decode path. A converged decode must give the
oracle's pixels; a rejection must match the oracle's; any other exception
fails.

These tests need a CUDA device and skip without one. Run them on the GPU
machine (which need not have jax) with:

    python -m pytest --noconftest -m gpu -q tests/test_torch_fuzz_gpu.py

A read past a kernel's input is silent on the card. The last tests put
the inputs of decode_scan, block_maps and expand_px in views of larger
buffers whose bytes before and after them are filled three ways, and
require the same results each time, equal to the oracle's or the twin's.
"""
import numpy as np
import pytest
import torch

from qoi_tpu_torch import format as fmt
from qoi_tpu_torch import oracle
from qoi_tpu_torch._bits import to_i32
from qoi_tpu_torch.kernels import _build
from qoi_tpu_torch.kernels import block_maps as kbm
from qoi_tpu_torch.kernels import expand as kexp
from qoi_tpu_torch.kernels import scan_codec as kscan
from qoi_tpu_torch.models import decode_pipeline, decode_v3, scan_codec
from qoi_tpu_torch.utils import fuzzcases as fz
from qoi_tpu_torch.utils import testimages

pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def families():
    return {k: (cases, [fz.oracle_answer(c) for c in cases])
            for k, cases in fz.families(full=True).items()}


def _stream(img):
    h, w, ch = img.shape
    return oracle.encode(img, fmt.StreamDesc(w, h, ch))


@pytest.fixture(scope="module")
def card_4k():
    """(f') on the 4K mixed and photo frames (seed 3, as chip_smoke.py)."""
    bases = [_stream(testimages.mixed(3840, 2160, 4, seed=3)),
             _stream(testimages.photo(3840, 2160, 4, seed=3))]
    cases = fz.card_cases(bases)
    return cases, [fz.oracle_answer(c) for c in cases]


@pytest.fixture(scope="module")
def card_256():
    cases = fz.card_cases([_stream(testimages.mixed(256, 256, 4, seed=3))],
                          n_trunc=0, seed=8)
    return cases, [fz.oracle_answer(c) for c in cases]


@pytest.mark.parametrize("path", fz.DECODE_PATHS)
@pytest.mark.parametrize("family", "abcdefg")
def test_decode_family_on_card_matches_oracle(dev, families, family, path):
    cases, wants = families[family]
    assert fz.check_decode(path, cases, dev, wants) == []


@pytest.mark.parametrize("path", fz.ENCODE_PATHS)
def test_encode_random_images_on_card_match_oracle(dev, path):
    assert fz.check_encode(path, fz.encode_images(30), dev) == []


@pytest.mark.parametrize("path", fz.DECODE_PATHS[:2])
def test_card_sized_mutations_match_oracle(dev, card_4k, path):
    """(f') at 4K through P1 and P2; block_maps and expand ran."""
    cases, wants = card_4k
    _build.reset_launches()
    assert fz.check_decode(path, cases, dev, wants) == []
    torch.cuda.synchronize()
    for k in ("block_maps", "expand_px"):
        assert _build.launches[k] > 0, _build.launches


def test_card_sized_mutations_dense_decode(dev, card_4k):
    """(f') at 4K through _decode_device(dense=True): every converged
    decode is the oracle's pixels; slide_val2 ran."""
    cases, wants = card_4k
    _build.reset_launches()
    problems, n_conv = fz.check_dense(cases, dev, wants)
    assert problems == []
    assert n_conv > 0 and _build.launches["slide_val2"] > 0


@pytest.mark.parametrize("path", fz.DECODE_PATHS)
def test_mutated_256_streams_match_oracle(dev, card_256, path):
    cases, wants = card_256
    assert len(cases) == 8
    assert fz.check_decode(path, cases, dev, wants) == []


#: the byte values around a kernel's inputs in the poison tests
POISONS = (0x00, 0xFF, 0x5A)


def poisoned(x: torch.Tensor, fill: int, dev, lead: int = 0):
    """x on `dev` as a view of a larger buffer: `lead` elements before it
    and 4096 bytes after it hold the byte `fill`."""
    flat = x.reshape(-1)
    n = flat.numel()
    big = torch.empty(lead + n + 4096 // flat.element_size(),
                      dtype=x.dtype, device=dev)
    big.view(torch.uint8).fill_(fill)
    big[lead:lead + n] = flat.to(dev)
    return big[lead:lead + n].view(x.shape)


def test_decode_scan_reads_nothing_past_its_stream(dev, families):
    """Every stream the oracle accepts of (c), (f) and (g), its chunk bytes
    7 bytes into a poisoned buffer (the kernel stages 16-byte aligned
    segments): decode_scan's pixels and exit state are the same for every
    poison, and its pixels the oracle's."""
    seed65 = scan_codec._pack65(scan_codec._SEED, torch.zeros(
        (64, 4), dtype=torch.uint8)).to(dev)
    n = 0
    for fam in "cfg":
        cases, wants = families[fam]
        for c, w in zip(cases, wants):
            if w is None:
                continue
            desc = fmt.unpack_header(c.data)
            chunks = torch.from_numpy(np.frombuffer(
                c.data, np.uint8)[fmt.HEADER_SIZE:].copy())
            clen = len(c.data) - fmt.HEADER_SIZE - fmt.TRAILER_SIZE
            outs = [kscan.decode_scan(poisoned(chunks, fill, dev, lead=7),
                                      desc.num_pixels, clen, seed65)
                    for fill in POISONS]
            want = np.ascontiguousarray(oracle.decode(c.data, 4)[0])
            for px, st in outs:
                assert torch.equal(px.cpu(), outs[0][0].cpu())
                assert torch.equal(st.cpu(), outs[0][1].cpu())
            assert np.array_equal(outs[0][0].cpu().numpy().view(np.uint8)
                                  .reshape(want.shape), want)
            n += 1
    assert n > 150


def test_block_maps_and_expand_read_nothing_past_their_planes(dev,
                                                               families):
    """Round 1 of the decode of 30 streams of (f): block_maps on its
    position-major planes and expand_px on the decode's per-byte px and
    offsets, each plane in a poisoned buffer, equal the twins on the
    CPU for every poison."""
    for c in families["f"][0][:30]:
        body = np.frombuffer(c.data, np.uint8)[fmt.HEADER_SIZE:]
        pad = np.zeros(decode_pipeline.bucket_size_fine(len(body)), np.uint8)
        pad[:len(body)] = body
        data = torch.from_numpy(pad).to(dev)
        clen = len(c.data) - fmt.HEADER_SIZE - fmt.TRAILER_SIZE
        m = data.shape[0]
        b = decode_v3._scan_block_len(m)
        starts, cls, r6, d32, lit32, npix = decode_v3._fields(data, clen)
        w0, _ = decode_v3._initial_w(cls, r6, d32, lit32, npix)
        w0 = torch.where(starts, w0, 0)
        planes = [decode_v3._pos_major(x, m, b).cpu() for x in (
            ((cls | (r6 << 9)) | (w0 << 3)).to(torch.int32), to_i32(d32),
            to_i32(lit32))]
        want = kbm.block_maps(*planes)
        for fill in POISONS:
            got = kbm.block_maps(*(poisoned(p, fill, dev) for p in planes))
            for g, w_ in zip(got, want):
                assert torch.equal(g.cpu(), w_)
        px, _, _, pix_off, _, _, _ = decode_v3._decode_core(data, clen)
        cap = decode_pipeline.bucket_size(
            fmt.unpack_header(c.data).num_pixels)
        off, px32 = pix_off.to(torch.int32).cpu(), to_i32(px).cpu()
        want = kexp.expand_px(off, px32, cap)
        for fill in POISONS:
            got = kexp.expand_px(poisoned(off, fill, dev),
                                 poisoned(px32, fill, dev), cap)
            assert torch.equal(got.cpu(), want)
