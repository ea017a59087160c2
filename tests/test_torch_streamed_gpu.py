"""The streamed path of qoi_tpu_torch on the card: images above
STREAM_THRESHOLD_PX through the facade, against the C++ oracle's bytes
and the source pixels.

These tests need a CUDA device and skip without one. Run them on the GPU
machine (which need not have jax) with:

    python -m pytest --noconftest -m gpu tests/test_torch_streamed_gpu.py -q

`test_envelope_400mpx` is also marked slow: the format's largest image
at width 25600, about a minute and 5 GB of host memory.
"""
import time

import numpy as np
import pytest
import torch

import qoi_tpu_torch
from qoi_tpu_torch import format as fmt
from qoi_tpu_torch import oracle
from qoi_tpu_torch.kernels import _build
from qoi_tpu_torch.utils import testimages

pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _roundtrip(dev, img):
    h, w, ch = img.shape
    desc = fmt.StreamDesc(w, h, ch)
    assert desc.num_pixels > qoi_tpu_torch.STREAM_THRESHOLD_PX
    want = oracle.encode(img, desc)
    assert qoi_tpu_torch.encode(img, device=dev) == want
    got, gdesc = qoi_tpu_torch.decode(want, device=dev)
    assert gdesc == desc
    np.testing.assert_array_equal(got, img)
    return want


@pytest.mark.parametrize("case", ["mixed_rgba", "photo_rgb"])
def test_streamed_8k_roundtrip(dev, case):
    img = (testimages.mixed(7680, 4320, 4, seed=3) if case == "mixed_rgba"
           else testimages.photo(7680, 4320, 3, seed=3))
    _roundtrip(dev, img)


def test_streamed_8k_channel_forcing_and_truncation(dev):
    img = testimages.mixed(7680, 4320, 4, seed=4)
    stream = oracle.encode(img, fmt.StreamDesc(7680, 4320, 4))
    got, _ = qoi_tpu_torch.decode(stream, 3, device=dev)
    np.testing.assert_array_equal(got, img[..., :3])
    cut = stream[: len(stream) * 3 // 5] + fmt.TRAILER
    np.testing.assert_array_equal(qoi_tpu_torch.decode(cut, device=dev)[0],
                                  oracle.decode(cut)[0])


def test_streamed_adversarial_takes_the_scan(dev):
    """INDEX reads of a never-written slot: every tile fails the fixpoint
    and the decode_scan kernel repairs it from the tile's entry state."""
    desc = fmt.StreamDesc(4096, 4097, 4)
    adv = fmt.pack_header(desc) + b"\x05" * desc.num_pixels + fmt.TRAILER
    _build.reset_launches()
    got, _ = qoi_tpu_torch.decode(adv, device=dev)
    assert _build.launches["decode_scan"] > 0
    np.testing.assert_array_equal(got, oracle.decode(adv)[0])


@pytest.mark.slow
def test_envelope_400mpx(dev):
    """25600 x 15624 RGBA mixed, seed 11 (ENVELOPE400.md's image): the
    streamed encode equals the oracle's bytes and the decode the source
    pixels. Prints the times."""
    w, h = 25600, 15624
    t0 = time.perf_counter()
    img = testimages.mixed(w, h, 4, seed=11)
    desc = fmt.StreamDesc(w, h, 4)
    t1 = time.perf_counter()
    want = oracle.encode(img, desc)
    t2 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    got = qoi_tpu_torch.encode(img, device=dev)
    t3 = time.perf_counter()
    peak_enc = torch.cuda.max_memory_allocated()
    assert got == want
    del got
    torch.cuda.reset_peak_memory_stats()
    t4 = time.perf_counter()
    back, _ = qoi_tpu_torch.decode(want, device=dev)
    t5 = time.perf_counter()
    peak_dec = torch.cuda.max_memory_allocated()
    assert np.array_equal(back, img)
    n = desc.num_pixels
    print(f"\nenvelope {w}x{h} RGBA mixed seed 11, {n} px, stream "
          f"{len(want)} B: image {t1 - t0:.1f} s, oracle encode "
          f"{t2 - t1:.3f} s; streamed encode {t3 - t2:.3f} s "
          f"({n / 1e6 / (t3 - t2):.3f} Mpx/s, peak {peak_enc / 2**30:.3f} "
          f"GiB), streamed decode {t5 - t4:.3f} s "
          f"({n / 1e6 / (t5 - t4):.3f} Mpx/s, peak "
          f"{peak_dec / 2**30:.3f} GiB)")
