"""qoi_tpu_torch's sequential codec (models/scan_codec, the plain twins of
the two scan kernels) against the JAX package's lax.scans and the C++
oracle, on the CPU. Exact equality everywhere."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import qoi_tpu_torch
from qoi_tpu.models import scan_codec as jscan
from qoi_tpu.utils import testimages
from qoi_tpu_torch import format as fmt
from qoi_tpu_torch import oracle
from qoi_tpu_torch.models import scan_codec as tscan
from torch_testutil import e2e_cases, e2e_image

pytestmark = pytest.mark.skipif(not oracle.available(),
                                reason="oracle not built")

CPU = torch.device("cpu")

_jax_decode_scan = jax.jit(jscan._decode_scan, static_argnums=(1,))


def _stream(img):
    h, w, ch = img.shape
    return oracle.encode(img, fmt.StreamDesc(w, h, ch))


def test_hash_and_classify_literal_match_jax():
    rng = np.random.default_rng(0)
    px = rng.integers(0, 256, (4000, 4)).astype(np.uint8)
    prev = px.copy()
    prev[:, :3] = (px[:, :3].astype(np.int64)
                   + rng.integers(-40, 40, (4000, 3))).astype(np.uint8)
    prev[::3, 3] = rng.integers(0, 256, prev[::3].shape[0])
    np.testing.assert_array_equal(np.asarray(jscan._hash64(jnp.asarray(px))),
                                  tscan._hash64(torch.from_numpy(px)).numpy())
    want = jscan.classify_literal(jnp.asarray(px), jnp.asarray(prev))
    got = tscan.classify_literal(torch.from_numpy(px), torch.from_numpy(prev))
    for a, b in zip(want, got):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


@pytest.mark.parametrize("case", ["mixed", "runs_rgb", "noise", "palette"])
def test_encode_scan_matches_jax(case):
    img = {"mixed": lambda: testimages.mixed(60, 30, 4),
           "runs_rgb": lambda: testimages.runs_with_caps(130, 4, 3),
           "noise": lambda: testimages.noise(40, 20, 4, seed=3),
           "palette": lambda: testimages.palette(50, 20, 4, colors=5)}[case]()
    h, w, ch = img.shape
    px4 = img.reshape(-1, ch)
    if ch == 3:
        px4 = np.concatenate([px4, np.full((px4.shape[0], 1), 255,
                                           np.uint8)], axis=1)
    want = jax.jit(jscan._encode_scan)(jnp.asarray(px4))
    got = tscan._encode_scan(torch.from_numpy(np.ascontiguousarray(px4)))
    assert got[0].dtype == torch.uint8 and got[1].dtype == torch.int32
    for a, b in zip(want, got):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


@pytest.mark.parametrize("name,ch", e2e_cases())
def test_scan_codec_matches_oracle(name, ch):
    img = e2e_image(name, ch)
    stream = _stream(img)
    h, w, _ = img.shape
    assert tscan.encode(img, fmt.StreamDesc(w, h, ch), CPU) == stream
    got, desc = tscan.decode(stream, 0, CPU)
    assert (desc.width, desc.height, desc.channels) == (w, h, ch)
    np.testing.assert_array_equal(got, img)


@pytest.mark.parametrize("channels", [0, 3, 4])
@pytest.mark.parametrize("cut", [None, 11, 500])
def test_scan_decode_truncation_and_channels(channels, cut):
    full = _stream(testimages.mixed(40, 30, 4))
    data = full if cut is None else full[: fmt.HEADER_SIZE + cut] \
        + fmt.TRAILER
    np.testing.assert_array_equal(tscan.decode(data, channels, CPU)[0],
                                  oracle.decode(data, channels)[0])


@pytest.mark.parametrize("case", ["mixed", "adversarial", "truncated"])
def test_decode_scan_with_entry_state_matches_jax(case):
    """From a random entry px and table (a chained tile's state): the
    pixels and the exit px and table equal JAX `_decode_scan`'s."""
    if case == "adversarial":
        body, clen = b"\x05" * 900 + fmt.TRAILER, 900
    else:
        s = _stream(testimages.mixed(30, 30, 4, seed=6))
        body = s[fmt.HEADER_SIZE:]
        clen = len(body) - fmt.TRAILER_SIZE
        if case == "truncated":
            clen //= 2
    data = np.frombuffer(body, np.uint8).copy()
    rng = np.random.default_rng(len(body))
    e_px = rng.integers(0, 256, 4).astype(np.uint8)
    e_tab = rng.integers(0, 256, (64, 4)).astype(np.uint8)
    want = _jax_decode_scan(jnp.asarray(data), 900, jnp.int32(clen),
                            jnp.asarray(e_px), jnp.asarray(e_tab))
    got = tscan._decode_scan(torch.from_numpy(data), 900, clen,
                             torch.from_numpy(e_px), torch.from_numpy(e_tab))
    np.testing.assert_array_equal(np.asarray(want[0]), got[0].numpy())
    np.testing.assert_array_equal(np.asarray(want[1][0]), got[1][0].numpy())
    np.testing.assert_array_equal(np.asarray(want[1][1]), got[1][1].numpy())


def test_decode_scan_default_state_is_the_seed():
    data = np.frombuffer(_stream(testimages.photo(20, 10, 4)), np.uint8)[
        fmt.HEADER_SIZE:].copy()
    a = tscan._decode_scan(torch.from_numpy(data), 200, len(data) - 8)
    b = tscan._decode_scan(torch.from_numpy(data), 200, len(data) - 8,
                           torch.tensor(fmt.SEED_PIXEL, dtype=torch.uint8),
                           torch.zeros((64, 4), dtype=torch.uint8))
    for x, y in ((a[0], b[0]), (a[1][0], b[1][0]), (a[1][1], b[1][1])):
        assert torch.equal(x, y)


def test_ladder_decodes_through_the_scan_without_the_native_build(
        monkeypatch):
    """The adversarial stream fails the device fixpoint; without the C++
    decoder the ladder's floor is the sequential scan, behind the v1
    decoder (capped here at one iteration, on which it does not
    converge)."""
    from qoi_tpu_torch.models import decode_pipeline

    w, h = 64, 32
    data = fmt.pack_header(fmt.StreamDesc(w, h, 4)) + b"\x05" * (w * h) \
        + fmt.TRAILER
    want = oracle.decode(data)[0]
    monkeypatch.setattr(oracle, "available", lambda: False)
    monkeypatch.setattr(oracle, "decode", None)   # must not be reached
    monkeypatch.setattr(decode_pipeline, "_MAX_FIXPOINT_ITERS", 1)
    scan = tscan.decode
    seen = []
    monkeypatch.setattr(tscan, "decode",
                        lambda *a: seen.append(a[0]) or scan(*a))
    got, _ = qoi_tpu_torch.decode(data, device="cpu")
    np.testing.assert_array_equal(got, want)
    assert seen == [data]
