"""The numeric re-scan pass 3 of qoi_tpu_torch's decode_v3
(`_resolve_p(apply="scan")`, kernels/numeric_scan.py) against the JAX
package's `_numeric_scan` and against the vectorized apply, and the decode
ladder's order (the native decoder, else v1, else the scan). On the CPU
the wrapper runs its plain twin. The tolerance is exact equality
everywhere (an integer codec)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import qoi_tpu_torch
from qoi_tpu.models import decode_v3 as jd3
from qoi_tpu.utils import testimages
from qoi_tpu_torch import format as fmt
from qoi_tpu_torch import oracle
from qoi_tpu_torch.kernels import numeric_scan as tns
from qoi_tpu_torch.models import decode_pipeline as tv1
from qoi_tpu_torch.models import decode_v3 as td3
from qoi_tpu_torch.models import scan_codec as tscan
from torch_testutil import as_u32, assert_same, oracle_built, to_torch

pytestmark = pytest.mark.usefixtures("oracle_built")

#: every stream pads to this many bytes (b = 2048 positions, nb = 32
#: lanes), so the JAX side compiles one program a function
M = 65536

#: the six images of tests/test_decode_v3.py's scan-against-vector test
CASES = {
    "photo": lambda: testimages.photo(160, 96, 4, seed=5),
    "mixed": lambda: testimages.mixed(160, 96, 4, seed=3),
    "palette_alpha": lambda: testimages.palette_alpha(160, 96, colors=40,
                                                      seed=7),
    "runs_with_caps": lambda: testimages.runs_with_caps(160, 96, 4),
    "alpha_toggle": lambda: testimages.alpha_toggle(160, 96),
    "noise": lambda: testimages.noise(64, 48, 4, seed=1),
}

_SEED65 = np.zeros(65, np.uint32)
_SEED65[0] = np.frombuffer(bytes(fmt.SEED_PIXEL), np.uint32)[0]


def _random_entry(seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 1 << 32, 65, dtype=np.uint64).astype(np.uint32)


@pytest.fixture(scope="module")
def bodies():
    out = {}
    for name, make in CASES.items():
        img = make()
        h, w, ch = img.shape
        s = oracle.encode(img, fmt.StreamDesc(w, h, ch))
        raw = np.frombuffer(s, np.uint8)[fmt.HEADER_SIZE:]
        pad = np.zeros(M, np.uint8)
        pad[: len(raw)] = raw
        out[name] = (pad, len(s) - fmt.HEADER_SIZE - fmt.TRAILER_SIZE)
    return out


def _i32(a):
    return to_torch(np.asarray(a).view(np.int32))


# ---- the plain twin against the JAX scan -------------------------------

@jax.jit
def _jax_pass3(pad, clen, e65):
    """JAX passes 1 and 2 from the initial w under entry e65, then its
    numeric re-scan: the planes, the entry states and the scan's px and
    exit state."""
    starts, cls, r6, d32, lit32, npix = jd3._fields(pad, clen)
    w0, _ = jd3._initial_w(cls, r6, d32, lit32, e65[0], npix=npix)
    b = jd3._scan_block_len(M)
    nb = M // b
    meta = jd3._pos_major((cls | (r6 << 9) | (jnp.where(starts, w0, 0) << 3))
                          .astype(jnp.int32), M, b)
    d32p, lit32p = jd3._pos_major(d32, M, b), jd3._pos_major(lit32, M, b)
    root, val = jd3._block_maps(meta, d32p, lit32p, nb, b)
    entry = jd3._compose_entry_states(root, val, nb, e65)
    px, exit65 = jd3._numeric_scan(meta, d32p, lit32p, entry, nb)
    return meta, d32p, lit32p, entry, px, exit65


@pytest.mark.parametrize("entry", ["seed", "random"])
@pytest.mark.parametrize("case", ["mixed", "palette_alpha", "noise"])
def test_numeric_scan_plain_matches_jax(bodies, case, entry):
    pad, clen = bodies[case]
    e65 = _SEED65 if entry == "seed" else _random_entry(3)
    meta, d32p, lit32p, ent, px, exit65 = _jax_pass3(
        jnp.asarray(pad), jnp.int32(clen), jnp.asarray(e65))
    got = tns.numeric_scan(_i32(meta), _i32(d32p), _i32(lit32p), _i32(ent))
    assert got[0].dtype == got[1].dtype == torch.int32
    assert got[0].shape == (2048, 32) and got[1].shape == (65,)
    assert_same(px, got[0])
    assert_same(exit65, got[1])


@pytest.mark.parametrize("b,nb", [(16, 1), (16, 7), (48, 33)])
def test_numeric_scan_plain_random_planes_match_jax(b, nb):
    """Random planes with every cls value 0..7 on random slots, from a
    random entry state per lane."""
    rng = np.random.default_rng(b * nb)
    meta = (rng.integers(0, 8, (b, nb))
            | rng.integers(0, 64, (b, nb)) << 3).astype(np.int32)
    d32, lit32 = (rng.integers(0, 1 << 32, (b, nb), dtype=np.uint64)
                  .astype(np.uint32) for _ in range(2))
    entry = rng.integers(0, 1 << 32, (65, nb), dtype=np.uint64).astype(
        np.uint32)
    want = jax.jit(jd3._numeric_scan, static_argnums=(4,))(
        jnp.asarray(meta), jnp.asarray(d32), jnp.asarray(lit32),
        jnp.asarray(entry), nb)
    got = tns.numeric_scan(to_torch(meta), _i32(d32), _i32(lit32),
                           _i32(entry))
    for a, b_ in zip(want, got):
        assert_same(a, b_)


def test_numeric_scan_refuses_bad_shapes():
    z = torch.zeros((16, 4), dtype=torch.int32)
    with pytest.raises(ValueError):
        tns.numeric_scan(z, z, z[:, :3], torch.zeros((65, 4),
                                                     dtype=torch.int32))
    with pytest.raises(ValueError):
        tns.numeric_scan(z, z, z, torch.zeros((64, 4), dtype=torch.int32))


# ---- _resolve(apply="scan") ---------------------------------------------

@jax.jit
def _jax_resolve(pad, clen, e65):
    """JAX `_resolve` under both applies from the initial w."""
    starts, cls, r6, d32, lit32, _ = jd3._fields(pad, clen)
    w0 = jnp.where(starts,
                   jd3._initial_w(cls, r6, d32, lit32, e65[0]), 0)
    b = jd3._scan_block_len(M)
    return tuple(jd3._resolve(cls, r6, w0, d32, lit32, M, b, entry65=e65,
                              apply=apply) for apply in ("scan", "vector"))


@pytest.mark.parametrize("entry", ["seed", "chained"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_resolve_scan_apply_matches_vector_and_jax(bodies, case, entry):
    """px after every byte and the exit state: the numeric re-scan equals
    the vectorized apply, and both equal the JAX package's, from the seed
    and from a random chained entry state."""
    pad, clen = bodies[case]
    e65 = None if entry == "seed" else _random_entry(11)
    (js_px, js_ex), (jv_px, jv_ex) = _jax_resolve(
        jnp.asarray(pad), jnp.int32(clen),
        jnp.asarray(_SEED65 if e65 is None else e65))
    e65_t = None if e65 is None else to_torch(e65.astype(np.int64))
    starts, cls, r6, d32, lit32, npix = td3._fields(to_torch(pad), clen)
    w0, _ = td3._initial_w(cls, r6, d32, lit32, npix,
                           None if e65_t is None else e65_t[0])
    w0 = torch.where(starts, w0, 0)
    b = td3._scan_block_len(M)
    ps, es = td3._resolve(cls, r6, w0, d32, lit32, M, b, e65_t, "scan")
    pv, ev = td3._resolve(cls, r6, w0, d32, lit32, M, b, e65_t, "vector")
    assert torch.equal(ps, pv) and torch.equal(es, ev)
    for want, got in ((js_px, ps), (js_ex, es), (jv_px, pv), (jv_ex, ev)):
        assert_same(want, got)
    np.testing.assert_array_equal(as_u32(js_px), as_u32(jv_px))


def test_resolve_p_refuses_an_unknown_apply(bodies):
    pad, clen = bodies["noise"]
    starts, cls, r6, d32, lit32, _ = td3._fields(to_torch(pad), clen)
    b = td3._scan_block_len(M)
    with pytest.raises(ValueError, match="apply"):
        td3._resolve(cls, r6, torch.zeros_like(cls), d32, lit32, M, b,
                     apply="numeric")


# ---- the decode ladder ---------------------------------------------------

def _adversarial(w=64, h=32) -> bytes:
    """INDEX reads of a never-written slot: decode_v3's fixpoint stalls."""
    return (fmt.pack_header(fmt.StreamDesc(w, h, 4)) + b"\x05" * (w * h)
            + fmt.TRAILER)


@pytest.fixture
def hide_native(monkeypatch):
    """A function that hides the native decoder and returns a record of
    the calls of v1's and the scan's decodes."""
    def hide():
        seen = {"v1": [], "scan": []}
        v1, scan = tv1.decode, tscan.decode
        monkeypatch.setattr(oracle, "available", lambda: False)
        monkeypatch.setattr(oracle, "decode", None)   # must not be reached
        monkeypatch.setattr(tv1, "decode",
                            lambda *a: seen["v1"].append(a[0]) or v1(*a))
        monkeypatch.setattr(tscan, "decode",
                            lambda *a: seen["scan"].append(a[0]) or scan(*a))
        return seen
    return hide


@pytest.mark.parametrize("v1_iters", [12, 1])
def test_ladder_order_without_the_native_decoder(monkeypatch, hide_native,
                                                 v1_iters):
    """With the native decoder hidden, a stream on which decode_v3 stalls
    goes to v1, which decodes it on the device (two iterations); v1 capped
    at one iteration goes on to the sequential scan. Both exact."""
    data = _adversarial()
    want = oracle.decode(data)[0]
    seen = hide_native()
    monkeypatch.setattr(tv1, "_MAX_FIXPOINT_ITERS", v1_iters)
    got, _ = qoi_tpu_torch.decode(data, device="cpu")
    np.testing.assert_array_equal(got, want)
    assert seen["v1"] == [data]
    assert seen["scan"] == ([] if v1_iters > 1 else [data])


def test_ladder_takes_the_native_decoder_when_built(monkeypatch):
    """With the native decoder built, the ladder does not reach v1."""
    data = _adversarial()
    monkeypatch.setattr(tv1, "decode", None)   # must not be reached
    got, _ = td3._decode_ladder(data, 0, torch.device("cpu"))
    np.testing.assert_array_equal(got, oracle.decode(data)[0])
