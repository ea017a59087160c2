"""qoi_tpu_torch decode path vs the JAX package and the C++ oracle, on the
CPU (the kernels' plain twins). Every stage gets the same numpy inputs in
both packages; the tolerance is exact equality everywhere (an integer
codec)."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import qoi_tpu_torch
from qoi_tpu.kernels import expand as jexpand
from qoi_tpu.models import decode_pipeline as v1
from qoi_tpu.models import decode_v3 as jd3
from qoi_tpu.ops import fsm as jfsm
from qoi_tpu.utils import testimages
from qoi_tpu_torch import format as fmt
from qoi_tpu_torch import oracle
from qoi_tpu_torch.kernels import block_maps as tbm
from qoi_tpu_torch.kernels import expand as texpand
from qoi_tpu_torch.models import decode_pipeline
from qoi_tpu_torch.models import decode_v3 as td3
from qoi_tpu_torch.ops import fsm as tfsm
from torch_testutil import (as_u32, assert_same, e2e_cases, e2e_image,
                            to_torch)

pytestmark = pytest.mark.skipif(not oracle.available(),
                                reason="oracle not built")


def _stream(img):
    h, w, ch = img.shape
    return oracle.encode(img, fmt.StreamDesc(w, h, ch))


def _padded(stream):
    raw = np.frombuffer(stream, np.uint8)[fmt.HEADER_SIZE:]
    pad = np.zeros((decode_pipeline.bucket_size(len(raw)),), np.uint8)
    pad[: len(raw)] = raw
    return pad, len(stream) - fmt.HEADER_SIZE - fmt.TRAILER_SIZE


CLASSES = {
    "photo": lambda: testimages.photo(96, 64, 4, seed=5),
    "mixed": lambda: testimages.mixed(96, 64, 4, seed=3),
    "palette_alpha": lambda: testimages.palette_alpha(80, 48, colors=40),
}


@pytest.fixture(scope="module")
def streams():
    """Padded stream bodies per content class, with their JAX fields and
    initial written-slot estimate (numpy)."""
    out = {}
    for name, make in CLASSES.items():
        img = make()
        pad, clen = _padded(_stream(img))
        starts, cls, r6, d32, lit32, npix = (
            np.asarray(x) for x in jd3._fields(jnp.asarray(pad),
                                               jnp.int32(clen)))
        w0i, pix_off = jd3._initial_w(
            jnp.asarray(cls), jnp.asarray(r6), jnp.asarray(d32),
            jnp.asarray(lit32), npix=jnp.asarray(npix))
        w0 = np.where(starts, np.asarray(w0i), 0)
        out[name] = dict(img=img, pad=pad, clen=clen, starts=starts,
                         cls=cls, r6=r6, d32=d32, lit32=lit32, npix=npix,
                         w0=w0, pix_off=np.asarray(pix_off))
    return out


def _planes(s):
    """Position-major int32 pass-1 inputs (meta, d32, lit32) from w0."""
    m = s["pad"].shape[0]
    b = jd3._scan_block_len(m)
    meta = (s["cls"] | (s["r6"] << 9) | (s["w0"] << 3)).astype(np.int32)
    pm = lambda x: np.ascontiguousarray(x.reshape(m // b, b).T)
    return (pm(meta), pm(s["d32"]).view(np.int32),
            pm(s["lit32"]).view(np.int32), m, b)


@pytest.mark.parametrize("case", sorted(CLASSES))
def test_chunk_starts_matches_jax(streams, case):
    s = streams[case]
    want = jfsm.chunk_starts(jnp.asarray(s["pad"]), jnp.int32(s["clen"]))
    assert_same(want, tfsm.chunk_starts(to_torch(s["pad"]), s["clen"]))


@pytest.mark.parametrize("case", ["mixed", "palette_alpha"])
def test_fields_matches_jax(streams, case):
    s = streams[case]
    got = td3._fields(to_torch(s["pad"]), s["clen"])
    for name, b in zip(("starts", "cls", "r6", "d32", "lit32", "npix"), got):
        assert_same(s[name], b)


@pytest.mark.parametrize("case", ["mixed", "palette_alpha"])
def test_initial_w_matches_jax(streams, case):
    s = streams[case]
    w, pix_off = td3._initial_w(
        *(to_torch(s[k]).long() for k in ("cls", "r6", "d32", "lit32", "npix")))
    assert_same(np.where(s["starts"], s["w0"], 0),
                 torch.where(to_torch(s["starts"]), w, 0))
    assert_same(s["pix_off"], pix_off)


def test_anchored_w_matches_jax(streams):
    s = streams["palette_alpha"]
    rng = np.random.default_rng(3)
    px = rng.integers(0, 1 << 32, s["pad"].shape[0],
                      dtype=np.uint64).astype(np.uint32)
    want = jd3._anchored_w(jnp.asarray(s["cls"]), jnp.asarray(s["r6"]),
                           jnp.asarray(s["d32"]), jnp.asarray(px))
    got = td3._anchored_w(
        *(to_torch(s[k]).long() for k in ("cls", "r6", "d32")),
        to_torch(px.astype(np.int64)))
    assert_same(want, got)


@pytest.fixture(scope="module")
def pass1(streams):
    """JAX pass-1 outputs (root, val, proot, pval) and inputs per class."""
    out = {}
    for case in ("mixed", "palette_alpha"):
        meta, d32, lit32, m, b = _planes(streams[case])
        want = jd3._block_maps(
            jnp.asarray(meta), jnp.asarray(d32.view(np.uint32)),
            jnp.asarray(lit32.view(np.uint32)), m // b, b, emit_px=True)
        out[case] = ((meta, d32, lit32), tuple(np.asarray(x) for x in want))
    return out


@pytest.mark.parametrize("case", ["mixed", "palette_alpha"])
def test_block_maps_twin_matches_jax(pass1, case):
    (meta, d32, lit32), want = pass1[case]
    got = tbm.block_maps(to_torch(meta), to_torch(d32), to_torch(lit32))
    assert all(g.dtype == torch.int32 for g in got)
    for a, b in zip(want, got):
        assert_same(a, b)


@pytest.mark.parametrize("case", ["mixed", "palette_alpha"])
def test_compose_and_apply_match_jax(pass1, case):
    _, (root, val, proot, pval) = pass1[case]
    nb = root.shape[1]
    entry_j = jd3._compose_entry_states(jnp.asarray(root), jnp.asarray(val),
                                        nb)
    entry_t = td3._compose_entry_states(to_torch(root.view(np.int32)),
                                        to_torch(val.view(np.int32)))
    assert_same(entry_j, entry_t)
    px_j = jd3._apply_symbolic(jnp.asarray(proot), jnp.asarray(pval),
                               entry_j)
    px_t = td3._apply_symbolic(to_torch(proot.view(np.int32)),
                               to_torch(pval.view(np.int32)), entry_t)
    assert_same(px_j, px_t)


@pytest.fixture(scope="module")
def cores(streams):
    """JAX `_decode_core` outputs per class (no surgical round: the port
    has none, and at these sizes the JAX package would not engage it)."""
    out = {}
    for case, s in streams.items():
        px, starts, npix, pix_off, conv, rounds, _ = jd3._decode_core(
            jnp.asarray(s["pad"]), jnp.int32(s["clen"]), surgical=False)
        out[case] = tuple(np.asarray(x) for x in
                          (px, starts, npix, pix_off, conv, rounds))
    return out


@pytest.mark.parametrize("case", sorted(CLASSES))
def test_decode_core_matches_jax(streams, cores, case):
    s = streams[case]
    want = cores[case]
    got = td3._decode_core(to_torch(s["pad"]), s["clen"])
    for a, b in zip(want[:4], got[:4]):
        assert_same(a, b)
    assert bool(want[4]) == got[4]
    assert int(want[5]) == got[5]
    assert got[4], f"{case} must converge"


@pytest.mark.parametrize("case", ["photo", "palette_alpha"])
def test_expand_twin_matches_jax_xla_and_pallas_interpret(streams, cores,
                                                          case):
    """The plain twin of kernel B against expand_px_xla AND the Pallas
    expand kernel in interpret mode at the production geometry (accum
    "xw", tile 4096 / sub 128 / nblocks 4)."""
    px, _, _, pix_off = cores[case][:4]
    npc = decode_pipeline.bucket_size(streams[case]["img"].shape[0]
                              * streams[case]["img"].shape[1])
    want_xla = jexpand.expand_px_xla(jnp.asarray(pix_off), jnp.asarray(px),
                                     npc)
    want_pl = jexpand.expand_px(
        jnp.asarray(pix_off), jnp.asarray(px), npc, interpret=True,
        accum="xw", tile=jd3._EXPAND_TILE, sub=jd3._EXPAND_SUB,
        nblocks=jd3._EXPAND_NBLOCKS)
    got = texpand.expand_px(to_torch(pix_off.astype(np.int32)),
                            to_torch(px.view(np.int32)), npc)
    assert got.dtype == torch.int32
    assert_same(want_xla, got)
    assert_same(want_pl, got)


def test_expand_twin_truncates_and_keeps_seed():
    """Offsets past n_px_cap drop; pixels before the first chunk keep the
    seed; an empty stream is all seed."""
    pix_off = np.array([3, 3, 5, 9, 40, 41], np.int32)
    px = np.array([7, 7, 8, 9, 10, 11], np.uint32)
    want = jexpand.expand_px_xla(jnp.asarray(pix_off), jnp.asarray(px), 16)
    got = texpand.expand_px(to_torch(pix_off), to_torch(px.view(np.int32)), 16)
    assert_same(want, got)
    empty = texpand.expand_px(to_torch(np.zeros(0, np.int32)),
                              to_torch(np.zeros(0, np.int32)), 8)
    assert (as_u32(empty) == texpand._SEED32).all()


@pytest.mark.parametrize("name,ch", e2e_cases())
def test_decode_matches_oracle(name, ch):
    stream = _stream(e2e_image(name, ch))
    got, gdesc = qoi_tpu_torch.decode(stream, device="cpu")
    want, wdesc = oracle.decode(stream)
    assert gdesc == wdesc
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("cut", [11, 200, 1001])
def test_decode_truncated_matches_oracle(cut):
    full = _stream(testimages.mixed(40, 30, 4))
    data = full[: fmt.HEADER_SIZE + cut] + fmt.TRAILER
    np.testing.assert_array_equal(qoi_tpu_torch.decode(data, device="cpu")[0],
                                  oracle.decode(data)[0])


@pytest.mark.parametrize("channels", [0, 3, 4])
def test_decode_channel_forcing(channels):
    full = _stream(testimages.mixed(40, 30, 4))
    np.testing.assert_array_equal(
        qoi_tpu_torch.decode(full, channels, device="cpu")[0],
        oracle.decode(full, channels)[0])


def test_adversarial_stream_takes_the_ladder():
    """INDEX reads of a never-written slot break the table invariant: the
    device fixpoint must stall (not converge) and the ladder must return
    the oracle's pixels."""
    w, h = 64, 32
    data = fmt.pack_header(fmt.StreamDesc(w, h, 4)) + b"\x05" * (w * h) \
        + fmt.TRAILER
    pad, clen = _padded(data)
    _, conv, _ = td3._decode_device(to_torch(pad), clen, w * h)
    assert not conv
    np.testing.assert_array_equal(qoi_tpu_torch.decode(data, device="cpu")[0],
                                  oracle.decode(data)[0])


def test_decode_group_matches_sources():
    imgs = [testimages.mixed(48, 32, 4, seed=i) for i in range(3)]
    ss = [_stream(im) for im in imgs]
    cap = v1.bucket_size(max(len(s) - fmt.HEADER_SIZE for s in ss))
    data = np.zeros((3, cap), np.uint8)
    clens = []
    for i, s in enumerate(ss):
        body = np.frombuffer(s, np.uint8)[fmt.HEADER_SIZE:]
        data[i, : len(body)] = body
        clens.append(len(s) - 22)
    px32, conv, rounds = td3.decode_group(to_torch(data), clens,
                                          v1.bucket_size(48 * 32))
    assert bool(conv.all()) and (rounds >= 1).all()
    for i, im in enumerate(imgs):
        got = td3.unpack_px32(px32[i].numpy())[: 48 * 32]
        np.testing.assert_array_equal(got.reshape(32, 48, 4), im)
