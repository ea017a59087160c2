"""The encoder's table replay in two phases, qoi_tpu_torch.ops.table's
table_hit_local / table_hit_carry against qoi_tpu.ops.table's on the CPU:
the intermediates (per-block facts) and the outputs equal at block 64 and
32, with and without an incoming table; encode_stage_chunks(table_local=)
and encode_device_split against the JAX package's, and the split encode
against the oracle."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from qoi_tpu.models import pipeline as jpipe
from qoi_tpu.ops import table as jtable
from qoi_tpu_torch import format as fmt
from qoi_tpu_torch import oracle
from qoi_tpu_torch.models import pipeline
from qoi_tpu_torch.ops import table
from qoi_tpu_torch.utils import testimages
from torch_testutil import assert_same

_jlocal = jax.jit(jtable.table_hit_local, static_argnames=("block",))
_jcarry = jax.jit(jtable.table_hit_carry, static_argnames=("block",))


def _events(n, seed, kind):
    """(keys, packed values, write) of N positions: random pixels of a few
    colours (slot collisions, repeated values), or a real image's."""
    rng = np.random.default_rng(seed)
    if kind == "palette":
        pal = rng.integers(0, 256, size=(9, 4), dtype=np.uint8)
        px = pal[rng.integers(0, 9, size=n)]
    else:
        px = testimages.mixed(n, 1, 4, seed=seed).reshape(-1, 4)
    prev = np.concatenate([np.array([fmt.SEED_PIXEL], np.uint8), px[:-1]])
    write = ~np.all(px == prev, axis=1) & (rng.random(n) < 0.9)
    return px, write


def _incoming(seed):
    rng = np.random.default_rng(seed)
    tbl = rng.integers(0, 1 << 32, size=64, dtype=np.uint64).astype(np.uint32)
    return tbl, rng.random(64) < 0.5


@pytest.mark.parametrize("block", [64, 32])
@pytest.mark.parametrize("n,kind", [(1000, "palette"), (4096, "mixed"),
                                    (77, "palette")])
@pytest.mark.parametrize("with_incoming", [False, True])
def test_table_hit_phases_match_jax(block, n, kind, with_incoming):
    px, write = _events(n, n + block, kind)
    keys, vals = table.hash64(torch.from_numpy(px)), \
        table.pack_rgba(torch.from_numpy(px))
    jkeys, jvals = jtable.hash64(jnp.asarray(px)), \
        jtable.pack_rgba(jnp.asarray(px))
    local = table.table_hit_local(keys, vals, torch.from_numpy(write), block)
    jlocal = _jlocal(jkeys, jvals, jnp.asarray(write), block=block)
    for got, want in zip(local, jlocal):
        assert tuple(got.shape) == want.shape
        assert_same(want, got)
    inc = jinc = None
    if with_incoming:
        tbl, wr = _incoming(n)
        inc = (torch.from_numpy(tbl.astype(np.int64)), torch.from_numpy(wr))
        jinc = (jnp.asarray(tbl), jnp.asarray(wr))
    hit, (ft, fw) = table.table_hit_carry(local, keys, vals, block, inc)
    jhit, (jft, jfw) = _jcarry(jlocal, jkeys, jvals, block=block,
                               incoming=jinc)
    assert_same(jhit, hit)
    assert_same(jft, ft)
    assert_same(jfw, fw)
    # the one-block composition table_hit gives the same outputs
    hit1, (ft1, fw1) = table.table_hit(keys, vals, torch.from_numpy(write),
                                       incoming=inc)
    assert torch.equal(hit1, hit)
    assert torch.equal(ft1, ft) and torch.equal(fw1, fw)


def test_table_hit_block_changes_only_the_intermediates():
    """The per-block facts differ between widths; the outputs do not."""
    px, write = _events(640, 1, "palette")
    keys, vals = table.hash64(torch.from_numpy(px)), \
        table.pack_rgba(torch.from_numpy(px))
    w = torch.from_numpy(write)
    l64 = table.table_hit_local(keys, vals, w, 64)
    l32 = table.table_hit_local(keys, vals, w, 32)
    assert l64[2].shape == (10, 64) and l32[2].shape == (20, 64)
    assert not torch.equal(l64[1], l32[1])
    out64 = table.table_hit_carry(l64, keys, vals, 64)
    out32 = table.table_hit_carry(l32, keys, vals, 32)
    assert torch.equal(out64[0], out32[0])


def _frame(kind, w=96, h=40):
    return {"mixed": lambda: testimages.mixed(w, h, 4, seed=2),
            "palette_alpha": lambda: testimages.palette_alpha(w, h),
            "photo_rgb": lambda: testimages.photo(w, h, 3, seed=1)}[kind]()


@pytest.mark.parametrize("kind", ["mixed", "palette_alpha", "photo_rgb"])
@pytest.mark.parametrize("block", [64, 32])
def test_stage_chunks_table_local_matches_jax(kind, block):
    """encode_stage_chunks with a precomputed table_hit_local (and an
    incoming table, run and pixel): staging, lengths and carry as JAX's."""
    img = _frame(kind)
    h, w, ch = img.shape
    px4 = pipeline.force_rgba(img, fmt.StreamDesc(w, h, ch))
    n_valid = px4.shape[0] - 13
    tbl, wr = _incoming(block)
    prev = np.array([7, 7, 7, 7], np.uint8)
    eq = np.all(px4 == np.concatenate([prev[None], px4[:-1]]), axis=1)
    eq |= np.arange(px4.shape[0]) >= n_valid
    tpx = torch.from_numpy(px4)
    local = table.table_hit_local(table.hash64(tpx), table.pack_rgba(tpx),
                                  torch.from_numpy(~eq), block)
    jlocal = _jlocal(jtable.hash64(jnp.asarray(px4)),
                     jtable.pack_rgba(jnp.asarray(px4)),
                     jnp.asarray(~eq), block=block)
    got = pipeline.encode_stage_chunks(
        tpx, n_valid, prev_in=torch.from_numpy(prev), run_in=5,
        table_in=(torch.from_numpy(tbl.astype(np.int64)),
                  torch.from_numpy(wr)),
        contains_last=True, table_local=local, table_block=block,
        form="bytes")
    want = jpipe.encode_stage_chunks(
        jnp.asarray(px4), jnp.int32(n_valid), prev_in=jnp.asarray(prev),
        run_in=jnp.int32(5), table_in=(jnp.asarray(tbl), jnp.asarray(wr)),
        contains_last=jnp.bool_(True), table_local=jlocal,
        table_block=block)
    assert_same(want.staging, got.staging)
    assert_same(want.lens, got.lens)
    for a, b in zip(want.carry, got.carry):
        assert_same(a, b)


@pytest.mark.parametrize("kind", ["mixed", "palette_alpha", "photo_rgb"])
def test_encode_device_split_matches_jax_and_oracle(kind):
    """The two-phase encode: buffer and total as JAX's encode_device_split
    (the whole buffer, compact_bytes6's global-sort tier at this size),
    and the oracle's stream."""
    img = _frame(kind)
    h, w, ch = img.shape
    desc = fmt.StreamDesc(w, h, ch)
    px4 = pipeline.force_rgba(img, desc)
    n = px4.shape[0]
    padded = np.zeros((4096, 4), np.uint8)
    padded[:n] = px4
    for block in (64, 32):
        buf, total = pipeline.encode_device_split(torch.from_numpy(padded), n,
                                                  table_block=block)
        jbuf, jtotal = jpipe.encode_device_split(
            jnp.asarray(padded), jnp.int32(n), table_block=block)
        assert int(total) == int(jtotal)
        np.testing.assert_array_equal(buf.numpy(), np.asarray(jbuf))
        if oracle.available():
            stream = (fmt.pack_header(desc) + buf[: int(total)].numpy()
                      .tobytes() + fmt.TRAILER)
            assert stream == oracle.encode(img, desc)
