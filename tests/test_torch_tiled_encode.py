"""The sequence-parallel encode of qoi_tpu_torch.parallel on the CPU, in
one gloo group of S = 4 processes started once for the file: every rank
encodes the stream, which must equal the C++ oracle's bytes on the cases
of tests/test_tiled_encode.py (edge cases, the seed pixel at a tile
boundary, a spurious write, runs across tiles, the run cap at a boundary,
table hits across tiles), and each rank's tile step (bytes, total,
offset) must equal the JAX `_encode_tiled_device`'s shard on
make_mesh(1, 4) over the virtual CPU devices. Also the mesh layout and
collectives, dryrun_multichip(4), and io / the facade with
EngineConfig(mesh=...) against mesh=None."""
import numpy as np
import pytest

import jax.numpy as jnp

from qoi_tpu.parallel import sharding as jsharding
from qoi_tpu.parallel import tiled as jtiled
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


def _desc(img):
    h, w, ch = img.shape
    return fmt.StreamDesc(w, h, ch)


def _check(pool, img):
    want = oracle.encode(img, _desc(img))
    res = pool.run(tasks.encode, img)
    for rank, (stream, *_) in enumerate(res):
        assert stream == want, f"rank {rank}: {len(stream)} vs {len(want)} B"
    return res


@pytest.mark.parametrize("name", sorted(testimages.edge_case_suite(4)))
def test_tiled_edge_cases_rgba(pool, name):
    _check(pool, testimages.edge_case_suite(4)[name])


@pytest.mark.parametrize("name", ["gradient", "palette", "mixed", "flat_70px"])
def test_tiled_edge_cases_rgb(pool, name):
    _check(pool, testimages.edge_case_suite(3)[name])


def test_seed_pixel_at_tile_boundary(pool):
    """A tile whose first pixel is the seed (0,0,0,255) while the true
    incoming pixel differs: phase A misses the seed's write to slot 53,
    which the compose patches back in; later seed pixels probe it."""
    n = S * 128
    img = np.zeros((1, n, 4), np.uint8)
    img[..., :3] = 77
    img[..., 3] = 255
    for t in range(1, S):
        img[0, t * 128] = (0, 0, 0, 255)
        img[0, t * 128 + 60] = (0, 0, 0, 255)
        img[0, t * 128 + 61] = (t * 31 % 256, 5, 9, 255)
    _check(pool, img)


def test_boundary_eq_spurious_write(pool):
    """A tile whose first pixel equals the true incoming pixel but not the
    seed: phase A writes a slot the encoder does not, which is
    shadow-identical; runs cross every boundary at varied values."""
    n = S * 128
    img = np.zeros((1, n, 4), np.uint8)
    img[..., 3] = 255
    v = 0
    for i in range(0, n, 96):
        v = (v + 13) % 250 + 1
        img[0, i:i + 96, 0] = v
    _check(pool, img)


def test_run_crossing_tile_boundaries(pool):
    rng = np.random.default_rng(7)
    flat = np.empty((1, 1003, 4), np.uint8)
    pos = 0
    while pos < 1003:
        ln = int(rng.integers(40, 200))
        flat[0, pos:pos + ln] = rng.integers(0, 256, size=4, dtype=np.uint8)
        pos += ln
    _check(pool, flat)


def test_run_cap_aligned_with_boundary(pool):
    """One run of 62*S pixels: every tile boundary on a 62-cap flush."""
    _check(pool, testimages.flat(62 * S, 1, 4))


@pytest.mark.parametrize("shape", [(97, 13), (3, 1), (1, 1)])
def test_all_tiles_one_run(pool, shape):
    """One run over the whole stream (and streams shorter than the ranks:
    pad tiles emit nothing)."""
    _check(pool, testimages.flat(*shape, 4))


def test_table_hits_across_tiles(pool):
    _check(pool, testimages.palette(500, 3, 4, colors=9, seed=3))


def test_noise_large_odd_size(pool):
    _check(pool, testimages.noise(331, 7, 4, seed=11))


@pytest.mark.parametrize("kind", ["mixed", "palette", "runs"])
def test_shards_match_jax(pool, kind):
    """Each rank's tile step against the JAX `_encode_tiled_device` shard:
    total, offset and the tile's bytes in [0, total)."""
    img = {"mixed": lambda: testimages.mixed(60, 30, 4),
           "palette": lambda: testimages.palette(61, 17, 3, colors=7, seed=2),
           "runs": lambda: testimages.runs_with_caps(130, 3, 4)}[kind]()
    res = _check(pool, img)
    px4 = img.reshape(-1, img.shape[-1])
    if px4.shape[1] == 3:
        px4 = np.concatenate([px4, np.full((len(px4), 1), 255, np.uint8)], 1)
    n = px4.shape[0]
    b = max(-(-n // S), 2)
    padded = np.zeros((S * b, 4), np.uint8)
    padded[:n] = px4
    bufs, totals, offsets = jtiled._encode_tiled_device(
        jnp.asarray(padded), jnp.int32(n), mesh=jsharding.make_mesh(1, S),
        axis=jsharding.SEQ_AXIS)
    bufs = np.asarray(bufs).reshape(S, b * 6)
    for r, (_, buf, total, offset) in enumerate(res):
        assert total == int(totals[r]) and offset == int(offsets[r])
        assert buf.shape == (b * 6,)
        np.testing.assert_array_equal(buf[:total], bufs[r, :total])


def test_mesh_layout_and_collectives(pool):
    """seq innermost: rank r is (r // seq, r % seq); every collective of
    an Axis against its definition."""
    lay = pool.run(tasks.mesh_layout, 2, 2)
    assert lay == [(0, 0, [0, 1], [0, 2]), (0, 1, [0, 1], [1, 3]),
                   (1, 0, [2, 3], [0, 2]), (1, 1, [2, 3], [1, 3])]
    res = pool.run(tasks.collectives, 3)
    x = np.stack([np.arange(3 * S) + 100 * r for r in range(S)])
    for r, (gathered, reduced, scattered) in enumerate(res):
        np.testing.assert_array_equal(gathered, x[:, :3])
        np.testing.assert_array_equal(reduced, x.sum(axis=0))
        np.testing.assert_array_equal(scattered,
                                      x.sum(axis=0)[3 * r:3 * r + 3])


def test_dryrun_multichip(pool):
    """The (2, 2) step: every rank sees the same totals, their grand
    total, and a converged decode on every shard."""
    res = pool.run(tasks.run_dryrun, S)
    assert all(r == res[0] for r in res)
    assert res[0]["mesh"] == (2, 2)
    t = np.array(res[0]["totals"])
    assert t.shape == (4, 2) and res[0]["grand"] == t.sum() > 0
    assert res[0]["conv"] == [True] * S


@pytest.mark.parametrize("mesh_shape", [(1, S), (2, S // 2), (S, 1)])
def test_facade_reuses_one_mesh(pool, mesh_shape):
    """Two facade encodes with EngineConfig(mesh=...) inside the group:
    the first makes the mesh's process groups at most once, the second
    makes none, and make_mesh returns one mesh for the group."""
    data, seq = mesh_shape
    img = testimages.mixed(30, 11, 4, seed=2)
    for counts, same_bytes, same_mesh in pool.run(tasks.facade_groups, img,
                                                  mesh_shape):
        assert counts[0] in (0, 1 + data + seq) and counts[1] == 0
        assert same_bytes and same_mesh


@pytest.mark.parametrize("mesh_shape", [(1, S), (2, S // 2)])
def test_io_mesh_matches_single_device(pool, tmp_path, mesh_shape):
    """io.write/read and the facade with EngineConfig(mesh=...) inside the
    group: the bytes of the single-device encode (mesh=None) and the
    source pixels back."""
    import qoi_tpu_torch

    img = testimages.mixed(45, 21, 4, seed=5)
    single = qoi_tpu_torch.encode(img, device="cpu")
    assert single == oracle.encode(img, _desc(img))
    for written, facade, back in pool.run(tasks.io_roundtrip, img,
                                          mesh_shape, str(tmp_path / "m")):
        assert written == single and facade == single
        np.testing.assert_array_equal(back, img)
