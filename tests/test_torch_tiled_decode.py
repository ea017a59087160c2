"""The sequence-parallel decode of qoi_tpu_torch.parallel on the CPU, in
one gloo group of S = 4 processes started once for the file: every rank
decodes the stream, which must give the oracle's pixels on the cases of
tests/test_tiled_decode.py (edge cases, INDEX reaching across shards,
DIFF chains and runs across shards, the alpha-pull fixpoint, channel
forcing, a truncated stream), and each rank's outputs (px, npix, pix_off,
nloc, conv and the expanded pixel slice) must equal the JAX
`_decode_tiled_device` / `_decode_expand_device` shard on make_mesh(1, 4)
over the virtual CPU devices. Also the fallback to v1 when the sharded
fixpoint does not converge, and the mesh's counters."""
import numpy as np
import pytest

import jax.numpy as jnp

from qoi_tpu.parallel import sharding as jsharding
from qoi_tpu.parallel import tiled_decode as jtiled_decode
from qoi_tpu_torch import format as fmt
from qoi_tpu_torch import oracle
from qoi_tpu_torch.parallel.launch import RankPool
from qoi_tpu_torch.utils import testimages

import torch_parallel_tasks as tasks

S = 4

pytestmark = pytest.mark.skipif(not oracle.available(),
                                reason="oracle not built")


@pytest.fixture(scope="module")
def pool():
    with RankPool(S, device="cpu", timeout_s=120) as p:
        yield p


def _stream(img):
    h, w, ch = img.shape
    return oracle.encode(img, fmt.StreamDesc(w, h, ch))


def _check(pool, stream, channels=0, shards=False):
    want, wdesc = oracle.decode(stream, channels)
    res = pool.run(tasks.decode, stream, channels, shards)
    for rank, (img, extra) in enumerate(res):
        np.testing.assert_array_equal(img, want, err_msg=f"rank {rank}")
        if not shards:
            assert extra == (wdesc.width, wdesc.height, wdesc.channels)
    return res


@pytest.mark.parametrize("name", sorted(testimages.edge_case_suite(4)))
def test_tiled_decode_edge_cases_rgba(pool, name):
    _check(pool, _stream(testimages.edge_case_suite(4)[name]))


@pytest.mark.parametrize("name", ["gradient", "palette", "mixed",
                                  "noise_small"])
def test_tiled_decode_edge_cases_rgb(pool, name):
    _check(pool, _stream(testimages.edge_case_suite(3)[name]))


def test_index_reaching_across_shards(pool):
    _check(pool, _stream(testimages.palette(400, 5, 4, colors=10, seed=6)))


def test_diff_chains_crossing_shards(pool):
    _check(pool, _stream(testimages.gradient(300, 7, 3)))


def test_runs_spanning_shards(pool):
    _check(pool, _stream(testimages.flat(500, 4, 4)))


def _alpha_pull():
    rng = np.random.default_rng(11)
    img = rng.integers(0, 255, size=(6, 120, 4), dtype=np.uint8)
    img[..., 3] = 190
    img[0, 0, 3] = 120
    return img


def test_alpha_pull_fixpoint_across_shards(pool):
    _check(pool, _stream(_alpha_pull()))


def test_channel_forcing_tiled(pool):
    stream = _stream(testimages.mixed(60, 30, 4))
    for ch in (0, 3, 4):
        _check(pool, stream, ch)


def test_truncated_stream_tiled(pool):
    full = _stream(testimages.mixed(40, 20, 4))
    _check(pool, full[:fmt.HEADER_SIZE + 30] + fmt.TRAILER)


def _adversarial(w=24, h=10):
    """INDEX reads of a never-written slot: they decode the zero entry,
    whose hash is not the slot the optimistic guess assumed."""
    desc = fmt.StreamDesc(w, h, 4)
    return fmt.pack_header(desc) + b"\x05" * desc.num_pixels + fmt.TRAILER


def test_adversarial_stream(pool):
    _check(pool, _adversarial())


def test_unconverged_fixpoint_falls_back_to_v1(pool):
    """With the fixpoint capped at one round, the adversarial stream does
    not converge, and every rank decodes it with v1."""
    res = pool.run(tasks.decode_capped, _adversarial(), 1)
    want, _ = oracle.decode(_adversarial())
    for img, conv, reached_v1 in res:
        assert not conv and reached_v1
        np.testing.assert_array_equal(img, want)


def _jax_shards(stream):
    """The JAX per-shard outputs of one stream on make_mesh(1, S)."""
    body = np.frombuffer(stream, np.uint8)[fmt.HEADER_SIZE:]
    chunks_len = len(stream) - fmt.HEADER_SIZE - fmt.TRAILER_SIZE
    mb = max(-(-len(body) // S), 8)
    padded = np.zeros((S * mb,), np.uint8)
    padded[:len(body)] = body
    n_px = fmt.unpack_header(stream).num_pixels
    n_px_cap = -(-max(n_px, 1) // (64 * S)) * 64 * S
    mesh = jsharding.make_mesh(1, S)
    x = jnp.asarray(padded)
    px, npix, pix_off, nloc, conv = jtiled_decode._decode_tiled_device(
        x, jnp.int32(chunks_len), mesh=mesh, axis=jsharding.SEQ_AXIS)
    px32, conv2 = jtiled_decode._decode_expand_device(
        x, jnp.int32(chunks_len), mesh=mesh, axis=jsharding.SEQ_AXIS,
        n_px_cap=n_px_cap)
    split = lambda a: np.split(np.asarray(a), S)    # noqa: E731
    return (split(px), split(npix), split(pix_off), np.asarray(nloc),
            np.asarray(conv), split(px32), np.asarray(conv2))


@pytest.mark.parametrize("kind", ["mixed", "adversarial", "truncated"])
def test_shards_match_jax(pool, kind):
    """Each rank's outputs against the JAX shard: px after every chunk
    slot, pixel counts and offsets, chunk count, convergence, and the
    expanded pixel slice."""
    if kind == "adversarial":
        stream = _adversarial(40, 20)
    else:
        stream = _stream(testimages.mixed(60, 30, 4) if kind == "mixed"
                         else testimages.mixed(40, 20, 4))
    if kind == "truncated":
        stream = stream[:fmt.HEADER_SIZE + 30] + fmt.TRAILER
    res = _check(pool, stream, shards=True)
    px, npix, pix_off, nloc, conv, px32, conv2 = _jax_shards(stream)
    for r, (_, got) in enumerate(res):
        np.testing.assert_array_equal(got["px"], px[r])
        np.testing.assert_array_equal(got["npix"], npix[r])
        np.testing.assert_array_equal(got["pix_off"], pix_off[r])
        assert got["nloc"] == nloc[r]
        assert got["conv"] == bool(conv[r]) == got["conv_expand"] \
            == bool(conv2[r]) is True
        np.testing.assert_array_equal(got["px32"],
                                      px32[r].astype(np.int64))


def test_mesh_counters(pool):
    """The mesh counts its collectives and the seconds of the decode's
    phases."""
    for st in pool.run(tasks.stats_after_decode,
                       _stream(testimages.mixed(50, 20, 4))):
        # three stage exchanges, three a round, three to expand, one to
        # gather the pixels
        assert st["collectives"] >= 10 and st["collective_s"] > 0
        assert set(st["phase_s"]) == {"decode fields and hashes",
                                      "decode fixpoint", "decode expand"}
