"""qoi_tpu_torch's decode with entry and exit states, and its surgical
second round, against the JAX package on the CPU. The tolerance is exact
equality everywhere (an integer codec)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qoi_tpu.kernels import expand as jexpand
from qoi_tpu.models import decode_v3 as jd3
from qoi_tpu.ops import fsm as jfsm
from qoi_tpu.utils import testimages
from qoi_tpu_torch import format as fmt
from qoi_tpu_torch import oracle
from qoi_tpu_torch.kernels import expand as texpand
from qoi_tpu_torch.models import decode_v3 as td3
from qoi_tpu_torch.ops import fsm as tfsm
from torch_testutil import as_u32, assert_same, oracle_built, to_torch

pytestmark = pytest.mark.usefixtures("oracle_built")

#: every stream of the class tests pads to this many bytes, so the JAX
#: side compiles one program per entry kind
M = 32768

CLASSES = {
    "photo": lambda: testimages.photo(96, 64, 4, seed=5),
    "mixed": lambda: testimages.mixed(96, 64, 4, seed=3),
    "palette_alpha": lambda: testimages.palette_alpha(96, 64, colors=40,
                                                      seed=7),
    "runs_with_caps": lambda: testimages.runs_with_caps(96, 64, 4),
    "alpha_toggle": lambda: testimages.alpha_toggle(96, 64),
    "noise": lambda: testimages.noise(64, 48, 4, seed=1),
}


def _body(img):
    h, w, ch = img.shape
    s = oracle.encode(img, fmt.StreamDesc(w, h, ch))
    return (np.frombuffer(s, np.uint8)[fmt.HEADER_SIZE:],
            len(s) - fmt.HEADER_SIZE - fmt.TRAILER_SIZE)


def _padded(raw, m):
    pad = np.zeros(m, np.uint8)
    pad[: len(raw)] = raw[:m]
    return pad


def _random_entry(seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 1 << 32, 65, dtype=np.uint64).astype(np.uint32)


@pytest.fixture(scope="module")
def bodies():
    return {name: _body(make()) for name, make in CLASSES.items()}


# ---- chunk_starts_and_state --------------------------------------------

@pytest.mark.parametrize("case", ["mixed", "palette_alpha", "random"])
@pytest.mark.parametrize("cut", [None, 1, 777])
def test_chunk_starts_and_state_matches_jax(bodies, case, cut):
    if case == "random":
        raw = np.random.default_rng(4).integers(0, 256, 5000).astype(
            np.uint8)
        clen = 4992
    else:
        raw, clen = bodies[case]
    pad = _padded(raw, 8192)
    clen = clen if cut is None else min(cut, clen)
    want = jfsm.chunk_starts_and_state(jnp.asarray(pad), jnp.int32(clen))
    got = tfsm.chunk_starts_and_state(to_torch(pad), clen)
    assert got[1].dtype == torch.int8
    for a, b in zip(want, got):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    assert torch.equal(tfsm.chunk_starts(to_torch(pad), clen), got[0])


# ---- expand with a seed ------------------------------------------------

@pytest.mark.parametrize("seed32", [0, 0x01020304, 0xFFFFFFFF])
def test_expand_seed32_matches_jax(seed32):
    rng = np.random.default_rng(seed32 & 0xFF)
    npix = np.where(rng.random(300) < 0.5, rng.integers(1, 63, 300), 0)
    pix_off = (40 + np.cumsum(npix) - npix).astype(np.int32)
    px = rng.integers(0, 1 << 32, 300, dtype=np.uint64).astype(np.uint32)
    for cap in (2048, 4096 * 3):
        want = jexpand.expand_px_xla(jnp.asarray(pix_off), jnp.asarray(px),
                                     cap, seed32=jnp.uint32(seed32))
        for s in (seed32, torch.tensor(seed32)):
            got = texpand.expand_px(to_torch(pix_off),
                                    to_torch(px.view(np.int32)), cap,
                                    seed32=s)
            assert_same(want, got)


# ---- pass 2 and the whole core with an entry state -------------------

@jax.jit
def _jax_pass2(pad, clen, e65):
    """JAX pass 1 from the initial w under entry e65, then pass 2: the
    maps and the entry states with the exit state."""
    starts, cls, r6, d32, lit32, npix = jd3._fields(pad, clen)
    w0, _ = jd3._initial_w(cls, r6, d32, lit32, e65[0], npix=npix)
    b = jd3._scan_block_len(M)
    meta = jd3._pos_major((cls | (r6 << 9) | (jnp.where(starts, w0, 0) << 3))
                          .astype(jnp.int32), M, b)
    root, val = jd3._block_maps(meta, jd3._pos_major(d32, M, b),
                                jd3._pos_major(lit32, M, b), M // b, b)
    return root, val, jd3._compose_entry_states(root, val, M // b, e65,
                                                return_exit=True)


@pytest.mark.parametrize("case", ["mixed", "palette_alpha"])
def test_compose_entry_states_with_entry_matches_jax(bodies, case):
    raw, clen = bodies[case]
    e65 = _random_entry(1)
    root, val, want = _jax_pass2(jnp.asarray(_padded(raw, M)),
                                 jnp.int32(clen), jnp.asarray(e65))
    got = td3._compose_entry_states(
        to_torch(np.asarray(root).view(np.int32)),
        to_torch(np.asarray(val).view(np.int32)),
        to_torch(e65.astype(np.int64)), return_exit=True)
    for a, b_ in zip(want, got):
        assert_same(a, b_)
    assert_same(want[0], td3._compose_entry_states(
        to_torch(np.asarray(root).view(np.int32)),
        to_torch(np.asarray(val).view(np.int32)),
        to_torch(e65.astype(np.int64))))


_jax_core = jax.jit(jd3._decode_core, static_argnums=(2,),
                    static_argnames=("surgical",))


@pytest.mark.parametrize("entry", ["seed", "random"])
@pytest.mark.parametrize("case", sorted(CLASSES))
def test_decode_core_with_entry_matches_jax(bodies, case, entry):
    """px32, starts, pix_off, conv, rounds and exit65 from the seed and
    from a random chained entry state (which breaks the table invariant,
    so such decodes may stall: both packages must agree on that too)."""
    raw, clen = bodies[case]
    pad = _padded(raw, M)
    e65 = None if entry == "seed" else _random_entry(2)
    want = _jax_core(jnp.asarray(pad), jnp.int32(clen), 12,
                     None if e65 is None else jnp.asarray(e65))
    got = td3._decode_core(
        to_torch(pad), clen, 12,
        None if e65 is None else to_torch(e65.astype(np.int64)))
    for i in (0, 1, 3, 6):          # px32, starts, pix_off, exit65
        assert_same(want[i], got[i])
    assert bool(want[4]) == got[4]
    assert int(want[5]) == got[5]
    if entry == "seed":
        assert got[4], f"{case} must converge from the seed"


def test_decode_core_chains_a_real_exit_state():
    """A stream cut in two at a chunk boundary: the second half decoded
    from the first half's exit state gives the whole stream's px and
    exit state."""
    raw, clen = _body(testimages.mixed(96, 64, 4, seed=8))
    starts = tfsm.chunk_starts(to_torch(_padded(raw, M)), clen).numpy()
    cut = int(np.flatnonzero(starts)[len(np.flatnonzero(starts)) // 2])
    whole = td3._decode_core(to_torch(_padded(raw, M)), clen)
    first = td3._decode_core(to_torch(_padded(raw[:cut], M)), cut)
    second = td3._decode_core(to_torch(_padded(raw[cut:], M)), clen - cut,
                              entry65=first[6])
    assert whole[4] and first[4] and second[4]
    np.testing.assert_array_equal(whole[0][cut:clen].numpy(),
                                  second[0][:clen - cut].numpy())
    assert torch.equal(whole[6], second[6])


# ---- the surgical second round -----------------------------------------

@pytest.fixture
def small_blocks(monkeypatch):
    """Blocks of 16 positions in the port (not in the JAX package), so
    that nbk >= 256 at ~4-9 KiB, and a record of the surgical rounds."""
    monkeypatch.setattr(td3, "_SCAN_B_MAX", 16)
    calls = []
    orig = td3._surgical_round

    def spy(*args, **kw):
        calls.append(args[5].tolist())
        return orig(*args, **kw)

    monkeypatch.setattr(td3, "_surgical_round", spy)
    return calls


SURGICAL = {
    # a mixed stream whose round-1 mismatches sit in one block
    "mixed_converges_in_2": (lambda: testimages.mixed(64, 48, 4, seed=0),
                             None),
    # palette_alpha's mismatches need more than 8 windows
    "palette_alpha_overflows_k": (
        lambda: testimages.palette_alpha(64, 48, colors=40), None),
    # cut so that the dirty blocks end at the last block: the last window
    # clamps left and overlaps the one before it
    "dirty_at_the_end": (lambda: testimages.mixed(64, 96, 4, seed=5), 8832),
}


@pytest.mark.parametrize("case", sorted(SURGICAL))
def test_surgical_round_equals_full_rounds_and_jax(small_blocks, case):
    make, cut = SURGICAL[case]
    raw, clen = _body(make())
    if cut is None:
        m = 8192
    else:
        m, clen = cut, cut - 16
    pad = _padded(raw, m)
    got = td3._decode_core(to_torch(pad), clen)
    engaged = list(small_blocks)
    full = td3._decode_core(to_torch(pad), clen, surgical=False)
    assert len(small_blocks) == len(engaged), "surgical=False engaged it"
    # the JAX package at its own block length, on a buffer padded to a
    # multiple of it (the padding is past chunks_len)
    pj = _padded(raw[:m], -(-m // 256) * 256)
    want = _jax_core(jnp.asarray(pj), jnp.int32(clen), 12, None)
    for i in (0, 1, 2, 3):
        assert torch.equal(got[i], full[i])
        np.testing.assert_array_equal(as_u32(want[i])[:m], as_u32(got[i]))
    assert torch.equal(got[6], full[6])
    assert_same(want[6], got[6])
    assert got[4] and full[4] and bool(want[4])
    assert got[5] == full[5] == int(want[5]) == 2
    nbk = m // 16
    if case == "palette_alpha_overflows_k":
        assert not engaged
    else:
        assert len(engaged) == 1
        ids = [i for i in engaged[0] if i < nbk]
        overlap = len(ids) != len(set(ids))
        assert overlap == (case == "dirty_at_the_end")


def test_surgical_round_from_a_chained_entry_state(small_blocks):
    """A streamed tile's surgical round starts its first block's anchored
    scan from the entry px's hash: from a real exit state (a photo
    stream's), it engages and equals the full rounds and JAX."""
    raw0, clen0 = _body(testimages.photo(40, 30, 4, seed=2))
    first = td3._decode_core(to_torch(_padded(raw0, 8192)), clen0)
    assert first[4]
    raw, clen = _body(testimages.mixed(64, 48, 4, seed=0))
    pad = _padded(raw, 8192)
    got = td3._decode_core(to_torch(pad), clen, entry65=first[6])
    assert len(small_blocks) == 1
    full = td3._decode_core(to_torch(pad), clen, entry65=first[6],
                            surgical=False)
    want = _jax_core(jnp.asarray(pad), jnp.int32(clen), 12,
                     jnp.asarray(first[6].numpy().astype(np.uint32)))
    for i in (0, 1, 2, 3, 6):
        assert torch.equal(got[i], full[i])
        assert_same(want[i], got[i])
    assert got[4] and bool(want[4]) and got[5] == full[5] == int(want[5])


def test_surgical_windows_cover_clamp_and_overflow():
    nbk = 256
    mis = torch.zeros(nbk, dtype=torch.bool)
    mis[[245, 253]] = True
    ids = td3._surgical_windows(mis).tolist()
    # dirty 245, 246, 253, 254 -> windows 245..252 and 248..255 (clamped)
    assert ids[:16] == list(range(245, 253)) + list(range(248, 256))
    assert ids[16:] == [nbk] * 48
    mis[:] = False
    mis[::20] = True                  # 13 windows needed
    assert td3._surgical_windows(mis) is None
    mis[:] = False
    assert td3._surgical_windows(mis).tolist() == [nbk] * 64


def test_surgical_round_stays_off_under_its_conditions(small_blocks):
    """max_rounds = 1, fewer than 256 blocks, or surgical=False: no
    surgical round, and the same result as the JAX package."""
    raw, clen = _body(testimages.mixed(64, 48, 4, seed=0))
    pad = _padded(raw, 8192)
    r1 = td3._decode_core(to_torch(pad), clen, max_rounds=1)
    assert not r1[4] and r1[5] == 1
    small = td3._decode_core(to_torch(_padded(raw, 4096 - 16)), clen)
    assert not small_blocks
    want = _jax_core(jnp.asarray(pad), jnp.int32(clen), 1, None)
    assert_same(want[0], r1[0])
    assert bool(want[4]) == r1[4]
    assert small[5] >= 1
