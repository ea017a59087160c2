"""Record sets for the word compaction kernel (csrc/compact_words.cu), its
twin and its model, shared by the CPU tests and the card tests. No JAX.

A case is built for a tile of `tile` records, so that the CPU model can
run the kernel's geometry scaled down and the card the kernel's own:
N at a tile less one, one tile and one tile plus one; many tiles with
tiles of no bytes and of 1-3 bytes that lie inside a word; many tiles of
a few words each, at every alignment; a total of
each residue mod 4; a capacity that ends at the stream's last word, so
that the trailing word falls outside.
"""
import numpy as np
import torch

#: name: (N in tiles and records, kind, total mod 4 or None, capacity)
#: capacity "full" is ceil(6N / 4) * 4 (the callers'), "exact" 4 *
#: ceil(total / 4)
CASES = {
    "mixed-tile-less-one": ((1, -1), "mixed", None, "full"),
    "mixed-one-tile": ((1, 0), "mixed", None, "full"),
    "mixed-tile-plus-one": ((1, 1), "mixed", None, "full"),
    "dense6-one-tile": ((1, 0), "dense6", None, "full"),
    "dense6-ragged": ((2, 77), "dense6", None, "full"),
    "sparse-ragged": ((3, 1000), "sparse", None, "full"),
    "empty": ((1, 1), "empty", None, "full"),
    "one-record": ((0, 1), "mixed", 1, "full"),
    "straddle": ((40, 0), "straddle", None, "full"),
    "straddle-exact": ((40, 3), "straddle", None, "exact"),
    "small-tiles": ((48, 0), "small", None, "full"),
    "mod0": ((2, 3), "mixed", 0, "full"),
    "mod1": ((2, 3), "mixed", 1, "full"),
    "mod2": ((2, 3), "mixed", 2, "full"),
    "mod3": ((2, 3), "mixed", 3, "full"),
    "mod0-exact": ((2, 5), "mixed", 0, "exact"),
    "mod3-exact": ((2, 5), "sparse", 3, "exact"),
}


def _lens(n, kind, tile, rng):
    if kind == "mixed":
        return rng.integers(0, 7, n)
    if kind == "dense6":
        lens = np.full(n, 6)
        lens[-1] = 5
        return lens
    if kind == "sparse":
        return np.where(rng.random(n) < 0.05, rng.integers(1, 7, n), 0)
    if kind == "straddle":
        # each tile 0-3 bytes over one to three records, every seventh
        # tile a few dense records: words shared by many tiles
        lens = np.zeros(n, np.int64)
        for t0 in range(0, n, tile):
            size = min(tile, n - t0)
            if (t0 // tile) % 7 == 6:
                at = rng.integers(0, size, 5)
                lens[t0 + at] = rng.integers(1, 7, 5)
                continue
            nbytes = int(rng.integers(0, 4))
            for _ in range(nbytes):
                lens[t0 + int(rng.integers(0, size))] += 1
        return lens
    if kind == "small":
        # each tile 0-36 bytes in its first records: whole-word runs of
        # every length 0-8 at every alignment
        lens = np.zeros(n, np.int64)
        for t0 in range(0, n, tile):
            size = min(tile, n - t0, 6)
            lens[t0:t0 + size] = rng.integers(0, 7, size)
        return lens
    return np.zeros(n, np.int64)


def records(n, kind, seed, tile=4096, total_mod=None):
    """(lo, hi, lens) int64 u32 tensors: each record's bytes 0..3 and 4..5
    little-endian, random nonzero bytes below its length, zero past it."""
    rng = np.random.default_rng(seed)
    lens = _lens(n, kind, tile, rng).astype(np.int64)
    if total_mod is not None:
        # lengthen or shorten records until the total has that residue
        k = 0
        while int(lens.sum()) % 4 != total_mod:
            i = k % n
            lens[i] = lens[i] + 1 if lens[i] < 6 else 0
            k += 1
    b = rng.integers(1, 256, (n, 6)).astype(np.int64)
    b = np.where(np.arange(6)[None, :] < lens[:, None], b, 0)
    lo = b[:, 0] | b[:, 1] << 8 | b[:, 2] << 16 | b[:, 3] << 24
    hi = b[:, 4] | b[:, 5] << 8
    return (torch.from_numpy(lo), torch.from_numpy(hi),
            torch.from_numpy(lens))


def case(name, tile=4096):
    """(lo, hi, lens, capacity) of the named case at a tile of `tile`."""
    (tiles, extra), kind, total_mod, cap = CASES[name]
    n = tiles * tile + extra
    lo, hi, lens = records(n, kind, sum(map(ord, name)), tile, total_mod)
    if cap == "full":
        capacity = -(-6 * n // 4) * 4
    else:
        capacity = max(4, -(-int(lens.sum()) // 4) * 4)
    return lo, hi, lens, capacity
