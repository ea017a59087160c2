"""Inputs of the numeric_scan kernel's tests: the design emulation on the
CPU (tests/test_torch_numeric_scan_design.py) and the kernel on the card
(tests/test_torch_kernels_gpu.py). numpy only, no JAX.

Each case is four int32 numpy arrays: the position-major (b, nb) planes
meta = cls | w << 3 | r6 << 9, d32 and lit32, and the (65, nb) entry
states (row 0 the px, row 1+s slot s)."""
import numpy as np

CLS_ADD, CLS_RGB, CLS_RGBA, CLS_INDEX = 1, 2, 3, 4

#: INDEX steps in the deep case's chain: each reads the slot its ADD
#: writer wrote from the INDEX before it, all in the first 32 positions
DEEP = 15


def _words(rng, shape):
    return rng.integers(-2**31, 2**31, shape).astype(np.int32)


def random_planes(b, nb, seed):
    """Every cls value 0..7 on random slots, random r6 bits (ignored by
    the scan), random d32, lit32 and entry states."""
    rng = np.random.default_rng(seed)
    meta = (rng.integers(0, 8, (b, nb)) | rng.integers(0, 64, (b, nb)) << 3
            | rng.integers(0, 64, (b, nb)) << 9).astype(np.int32)
    return meta, _words(rng, (b, nb)), _words(rng, (b, nb)), \
        _words(rng, (65, nb))


def all_index_planes(b, nb, seed):
    """Every position an INDEX: each lane replays its entry table."""
    meta, d32, lit32, entry = random_planes(b, nb, seed)
    return (meta & ~7) | CLS_INDEX, d32, lit32, entry


def deep_chain_planes(b, nb, seed, depth=DEEP):
    """Random planes whose first window (positions 0..31) holds, in every
    lane, an RGBA on slot s0, then `depth` times an INDEX of the slot last
    written and an ADD onto a new slot: INDEX k's value is the ADD before
    it, which adds to INDEX k - 1's; the window's other positions are ADDs.
    A window resolves one INDEX a fixpoint round, so it takes depth + 1
    rounds (the last one changes nothing)."""
    assert 2 * depth + 1 <= 32 and b >= 32
    meta, d32, lit32, entry = random_planes(b, nb, seed)
    rng = np.random.default_rng(seed + 1)
    for n in range(nb):
        slots = rng.permutation(64)[: depth + 1]
        meta[:32, n] = CLS_ADD | rng.integers(0, 64, 32) << 3
        meta[0, n] = CLS_RGBA | slots[0] << 3
        for k in range(depth):
            meta[2 * k + 1, n] = CLS_INDEX | slots[k] << 3
            meta[2 * k + 2, n] = CLS_ADD | slots[k + 1] << 3
    return meta, d32, lit32, entry
