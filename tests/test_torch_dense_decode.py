"""qoi_tpu_torch dense decode expand (decode_v3._compact_chunks over the
two-plane slide, then the expand) vs the JAX package's Pallas kernels in
interpret mode, on the CPU (the plain twins). The same numpy inputs go to
both packages; every comparison is exact (integer bit patterns)."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from qoi_tpu.kernels import slide as jslide
from qoi_tpu.models import decode_v3 as jd3
from qoi_tpu_torch import format as fmt
from qoi_tpu_torch import oracle
from qoi_tpu_torch.kernels import slide as tslide
from qoi_tpu_torch.models import decode_pipeline
from qoi_tpu_torch.models import decode_v3 as td3
from qoi_tpu_torch.utils import testimages
from torch_testutil import as_u32, assert_same, to_torch

pytestmark = pytest.mark.skipif(not oracle.available(),
                                reason="oracle not built")

CLASSES = {
    "photo": lambda: testimages.photo(96, 64, 4, seed=5),
    "mixed": lambda: testimages.mixed(96, 64, 4, seed=3),
    "runs": lambda: testimages.runs_with_caps(130, 40, 3),
}


@pytest.fixture(scope="module")
def cores():
    """Per class: the padded body (M a multiple of 4096) and the port's
    `_decode_core` outputs as numpy (the decode tests hold those equal to
    the JAX ones), which feed both packages below."""
    out = {}
    for name, make in CLASSES.items():
        img = make()
        h, w, ch = img.shape
        s = oracle.encode(img, fmt.StreamDesc(w, h, ch))
        raw = np.frombuffer(s, np.uint8)[fmt.HEADER_SIZE:]
        pad = np.zeros(max(decode_pipeline.bucket_size(len(raw)), 4096),
                       np.uint8)
        pad[: len(raw)] = raw
        clen = len(s) - fmt.HEADER_SIZE - fmt.TRAILER_SIZE
        px, starts, _, pix_off, conv, _, _ = td3._decode_core(
            to_torch(pad), clen)
        assert conv
        out[name] = dict(img=img, pad=pad, clen=clen,
                         px=as_u32(px).astype(np.uint32),
                         starts=starts.numpy(),
                         pix_off=pix_off.numpy().astype(np.int32),
                         npc=decode_pipeline.bucket_size(w * h))
    return out


@pytest.mark.parametrize("case", sorted(CLASSES))
def test_slide_val2_twin_matches_jax(cores, case):
    """The two-plane slide on `_compact_chunks`' rows: the port's twin
    against the Pallas slide_val2 in interpret mode, whole planes."""
    c = cores[case]
    off_r, px_r, aux, _, _ = td3._chunk_events(
        to_torch(c["starts"]), to_torch(c["pix_off"]),
        to_torch(c["px"].astype(np.int64)))
    want = jslide.slide_val2(jnp.asarray(off_r.numpy()),
                             jnp.asarray(px_r.numpy()),
                             jnp.asarray(aux.numpy()), interpret=True)
    got = tslide.slide_val2(off_r, px_r, aux)
    assert all(g.dtype == torch.int32 for g in got)
    for a, b in zip(want, got):
        assert_same(a, b)


def test_slide_val2_random_events():
    """Random alive sets with distances = index - rank, rows of 512."""
    rng = np.random.default_rng(7)
    alive = rng.random((6, 512)) < 0.4
    alive[2] = False                          # an empty row
    alive[3] = True                           # a full one
    rank = np.cumsum(alive, axis=1) - alive
    d = np.where(alive, np.arange(512)[None, :] - rank, 0)
    aux = (alive | d << 1).astype(np.int32)
    v1 = rng.integers(-2**31, 2**31, (6, 512)).astype(np.int32)
    v2 = rng.integers(-2**31, 2**31, (6, 512)).astype(np.int32)
    want = jslide.slide_val2(jnp.asarray(v1), jnp.asarray(v2),
                             jnp.asarray(aux), interpret=True)
    got = tslide.slide_val2(to_torch(v1), to_torch(v2), to_torch(aux))
    for a, b in zip(want, got):
        assert_same(a, b)


@pytest.mark.parametrize("case", sorted(CLASSES))
def test_compact_chunks_matches_jax(cores, case):
    """off_d and px_d slot by slot: real records at the front, tail slots
    (pix_off = _INF, px = 0) after them."""
    c = cores[case]
    want = jd3._compact_chunks(jnp.asarray(c["starts"]),
                               jnp.asarray(c["pix_off"]),
                               jnp.asarray(c["px"]), interpret=True)
    got = td3._compact_chunks(to_torch(c["starts"]), to_torch(c["pix_off"]),
                              to_torch(c["px"].astype(np.int64)))
    assert all(g.dtype == torch.int32 for g in got)
    for a, b in zip(want, got):
        assert_same(a, b)
    n_chunks = int(c["starts"].sum())
    off_d = got[0].numpy()
    assert (off_d[n_chunks:] == td3._INF).all()
    assert (got[1].numpy()[n_chunks:] == 0).all()
    assert (np.diff(off_d[:n_chunks]) >= 0).all()


@pytest.mark.parametrize("case", sorted(CLASSES))
def test_expand_packed_dense_matches_jax(cores, case):
    """_expand_packed(dense=True) against the JAX dense geometry
    (use_kernel, interpret) and against the per-byte expand."""
    c = cores[case]
    want = jd3._expand_packed(
        jnp.asarray(c["starts"]), jnp.asarray(c["px"]),
        jnp.asarray(c["pix_off"]), c["npc"], use_kernel=True, dense=True,
        interpret=True)
    args = (to_torch(c["starts"]), to_torch(c["px"].astype(np.int64)),
            to_torch(c["pix_off"]), c["npc"])
    got = td3._expand_packed(*args, dense=True)
    assert_same(want, got)
    assert_same(td3._expand_packed(*args), got)


@pytest.mark.parametrize("case", sorted(CLASSES))
def test_decode_device_dense_matches_source(cores, case):
    c = cores[case]
    img = c["img"]
    h, w, ch = img.shape
    out, conv, _ = td3._decode_device(to_torch(c["pad"]), c["clen"],
                                      c["npc"], dense=True)
    assert conv
    px = td3.unpack_px32(out.numpy())[: w * h, :ch]
    np.testing.assert_array_equal(px.reshape(h, w, ch), img)
