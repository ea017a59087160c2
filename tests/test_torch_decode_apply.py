"""qoi_tpu_torch's decode with pass 3 picked by `apply=` ("vector", the
default, or "scan", the numeric re-scan that runs the numeric_scan kernel
on the card) against the JAX package's `_decode_device` / `_decode_core`
with the same `apply`, on the CPU (the JAX lax.scan path, the port's plain
twins). The tolerance is exact equality in pixels, per-byte px,
`converged` and `rounds` (an integer codec)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qoi_tpu.models import decode_v3 as jd3
from qoi_tpu.utils import testimages
from qoi_tpu_torch import format as fmt
from qoi_tpu_torch import oracle
from qoi_tpu_torch.models import decode_v3 as td3
from torch_testutil import as_u32, assert_same, oracle_built, to_torch

pytestmark = pytest.mark.usefixtures("oracle_built")

APPLY = ["vector", "scan"]

#: every stream pads to M bytes and N_PX pixels, so the JAX side compiles
#: one program an `apply`
M = 32768
N_PX = 8192

#: photo and mixed converge in one round; mixed_r2 and palette_alpha need
#: the second; adversarial (INDEX reads of a never-written slot) stalls
STREAMS = {
    "photo": lambda: testimages.photo(96, 64, 4, seed=5),
    "mixed": lambda: testimages.mixed(96, 64, 4, seed=3),
    "mixed_r2": lambda: testimages.mixed(64, 48, 4, seed=0),
    "palette_alpha_r2": lambda: testimages.palette_alpha(64, 48, colors=40),
    "alpha_toggle": lambda: testimages.alpha_toggle(96, 64),
}
ROUNDS = {"photo": 1, "mixed": 1, "mixed_r2": 2, "palette_alpha_r2": 2,
          "alpha_toggle": 1}


def _body(name):
    if name == "adversarial":
        desc = fmt.StreamDesc(64, 48, 4)
        s = fmt.pack_header(desc) + b"\x05" * desc.num_pixels + fmt.TRAILER
    else:
        img = STREAMS[name]()
        h, w, ch = img.shape
        s = oracle.encode(img, fmt.StreamDesc(w, h, ch))
    return (np.frombuffer(s, np.uint8)[fmt.HEADER_SIZE:],
            len(s) - fmt.HEADER_SIZE - fmt.TRAILER_SIZE)


def _padded(raw, m=M):
    pad = np.zeros(m, np.uint8)
    pad[: len(raw)] = raw[:m]
    return pad


@pytest.fixture(scope="module")
def bodies():
    return {name: _body(name) for name in [*STREAMS, "adversarial"]}


@pytest.fixture
def surgical_calls(monkeypatch):
    """Blocks of 16 positions in the port, so that nbk >= 256 at 8 KiB and
    the surgical round can engage, and a record of its calls."""
    monkeypatch.setattr(td3, "_SCAN_B_MAX", 16)
    calls = []
    orig = td3._surgical_round

    def spy(*args, **kw):
        calls.append(1)
        return orig(*args, **kw)

    monkeypatch.setattr(td3, "_surgical_round", spy)
    return calls


@pytest.mark.parametrize("apply", APPLY)
@pytest.mark.parametrize("case", [*sorted(STREAMS), "adversarial"])
def test_decode_device_apply_matches_jax(bodies, case, apply):
    raw, clen = bodies[case]
    pad = _padded(raw)
    want = jd3._decode_device(jnp.asarray(pad), jnp.int32(clen), N_PX,
                              apply=apply)
    got = td3._decode_device(to_torch(pad), clen, N_PX, apply=apply)
    assert_same(want[0], got[0])
    assert bool(want[1]) == got[1]
    assert int(want[2]) == got[2]
    if case == "adversarial":
        assert not got[1]
    else:
        assert got[1] and got[2] == ROUNDS[case]


@pytest.mark.parametrize("case", sorted(STREAMS))
def test_scan_and_vector_decode_the_same_pixels(bodies, case):
    raw, clen = bodies[case]
    pad = to_torch(_padded(raw))
    vec = td3._decode_device(pad, clen, N_PX)
    scan = td3._decode_device(pad, clen, N_PX, apply="scan")
    assert torch.equal(vec[0], scan[0])
    assert vec[1:] == scan[1:]


_jax_core = jax.jit(jd3._decode_core, static_argnums=(2,),
                    static_argnames=("apply", "surgical"))


def _exit_state_of(bodies, name):
    """The exit state of a converged decode of stream `name`: a real
    chained entry state."""
    raw, clen = bodies[name]
    first = td3._decode_core(to_torch(_padded(raw)), clen)
    assert first[4]
    return first[6]


def _random_entry(seed):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(0, 1 << 32, 65, dtype=np.uint64)
                            .astype(np.int64))


@pytest.mark.parametrize("apply", APPLY)
@pytest.mark.parametrize("entry", ["chained", "random"])
def test_decode_core_entry65_apply_matches_jax(bodies, entry, apply):
    """A tile chained from a real exit state (that of the photo stream),
    and from a random entry state (which breaks the table invariant, so
    the decode may stall: both packages must agree on that too): px32,
    starts, pix_off, exit65, converged and rounds."""
    e65 = (_exit_state_of(bodies, "photo") if entry == "chained"
           else _random_entry(3))
    raw, clen = bodies["mixed_r2"]
    pad = _padded(raw)
    want = _jax_core(jnp.asarray(pad), jnp.int32(clen), 12,
                     jnp.asarray(e65.numpy().astype(np.uint32)),
                     apply=apply)
    got = td3._decode_core(to_torch(pad), clen, 12, e65, apply=apply)
    for i in (0, 1, 3):             # px32, starts, pix_off
        assert_same(want[i], got[i])
    assert bool(want[4]) == got[4]
    assert int(want[5]) == got[5]
    if got[4]:
        assert_same(want[6], got[6])
    if entry == "chained":
        assert got[4], "a real exit state must chain"


@pytest.mark.parametrize("case", ["mixed_r2", "palette_alpha_r2"])
def test_scan_never_runs_the_surgical_round(bodies, surgical_calls, case):
    """At nbk >= 256 a two-round stream takes the surgical round with
    apply="vector" (where its windows suffice) and never with "scan", and
    both equal the JAX package with the same apply."""
    raw, clen = bodies[case]
    pad = _padded(raw, 8192)
    out = {}
    for apply in APPLY:
        before = len(surgical_calls)
        out[apply] = td3._decode_device(to_torch(pad), clen, N_PX,
                                        apply=apply)
        engaged = len(surgical_calls) - before
        if apply == "scan":
            assert engaged == 0, "apply='scan' ran the surgical round"
        elif case == "mixed_r2":
            assert engaged == 1
        want = jd3._decode_device(jnp.asarray(pad), jnp.int32(clen), N_PX,
                                  apply=apply)
        np.testing.assert_array_equal(as_u32(want[0]), as_u32(out[apply][0]))
        assert bool(want[1]) and out[apply][1]
        assert int(want[2]) == out[apply][2] == 2
    assert torch.equal(out["vector"][0], out["scan"][0])


def test_scan_with_surgical_true_equals_surgical_false(bodies,
                                                       surgical_calls):
    raw, clen = bodies["mixed_r2"]
    pad = to_torch(_padded(raw, 8192))
    on = td3._decode_core(pad, clen, apply="scan", surgical=True)
    off = td3._decode_core(pad, clen, apply="scan", surgical=False)
    assert not surgical_calls
    for a, b in zip(on[:4], off[:4]):
        assert torch.equal(a, b)
    assert on[4:6] == off[4:6] == (True, 2)


@pytest.mark.parametrize("entry", ["_decode_device", "_decode_core",
                                   "_resolve_p"])
def test_a_bad_apply_raises_before_device_work(bodies, monkeypatch, entry):
    """Any apply but "vector" or "scan" raises ValueError before the
    decode reads its input: no field, no block map is computed."""
    def no_work(*a, **kw):
        raise AssertionError("device work before the apply check")

    monkeypatch.setattr(td3, "_fields", no_work)
    monkeypatch.setattr(td3, "block_maps", no_work)
    raw, clen = bodies["photo"]
    pad = to_torch(_padded(raw))
    with pytest.raises(ValueError, match="apply"):
        if entry == "_decode_device":
            td3._decode_device(pad, clen, N_PX, apply="Scan")
        elif entry == "_decode_core":
            td3._decode_core(pad, clen, apply="symbolic")
        else:
            b = td3._scan_block_len(M)
            planes = [torch.zeros((b, M // b), dtype=torch.int32)] * 3
            td3._resolve_p(*planes, torch.zeros(M, dtype=torch.int64), M, b,
                           apply="")


def test_decode_group_keeps_the_vector_apply(bodies, monkeypatch):
    """decode_group takes no apply (as the JAX package's): its streams
    run pass 3 as "vector" without the surgical round."""
    seen = []
    orig = td3._decode_device

    def spy(*a, **kw):
        seen.append((kw.get("apply", "vector"), kw.get("surgical")))
        return orig(*a, **kw)

    monkeypatch.setattr(td3, "_decode_device", spy)
    rows = [bodies[c] for c in ("photo", "mixed_r2")]
    data = torch.stack([to_torch(_padded(r)) for r, _ in rows])
    out, conv, rounds = td3.decode_group(data, [c for _, c in rows], N_PX)
    assert seen == [("vector", False)] * 2
    assert conv.all() and rounds.tolist() == [1, 2]
