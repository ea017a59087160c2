"""qoi_tpu_torch.ops.compact's byte compactions against qoi_tpu.ops.compact
on the CPU: the same staging and lengths, made with numpy from a seed, go
through both, and the buffers and totals must be equal (exactly, in
[0, total) and past it wherever the JAX function defines the bytes). The
cases are those of tests/test_pipeline_encode.py: both tiers of
compact_bytes6, ragged N, the word form of the word-sum compaction."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from qoi_tpu.ops import compact as jcompact
from qoi_tpu_torch.ops import compact

K = 6


class _Jitted:
    """qoi_tpu.ops.compact with every function under jax.jit (the sizes
    and flags static), so that each shape compiles once."""

    _static = {"compact_bytes6_wordsum": ("capacity", "words_out"),
               "compact_bytes6": ("capacity", "seg"),
               "compact_bytes": ("capacity",),
               "compact_bytes_scatter": ("capacity",),
               "compact_bytes_hybrid": ("capacity", "width_stop"),
               "compact_bytes_merge": (),
               "_barrel_shift_right": ("max_shift",)}

    def __init__(self):
        for name, static in self._static.items():
            setattr(self, name, jax.jit(getattr(jcompact, name),
                                        static_argnames=static))


jcompact = _Jitted()


def _staging(n, kind, seed):
    """(N, 6) uint8 staging and (N,) int32 lengths of one length regime:
    mixed, dense6 (with a final partial word), sparse or empty."""
    rng = np.random.default_rng(seed)
    staging = rng.integers(1, 256, size=(n, K), dtype=np.uint8)
    if kind == "mixed":
        lens = rng.integers(0, K + 1, size=(n,))
    elif kind == "dense6":
        lens = np.full((n,), 6)
        lens[-1] = 5
    elif kind == "sparse":
        lens = np.where(rng.random(n) < 0.05,
                        rng.integers(1, K + 1, size=(n,)), 0)
    else:
        lens = np.zeros((n,))
    return staging, lens.astype(np.int32)


def _same(port, jax_out, upto=None):
    (buf, total), (jbuf, jtotal) = port, jax_out
    assert int(total) == int(jtotal)
    a, b = buf.numpy(), np.asarray(jbuf)
    if upto is not None:
        a, b = a[:upto], b[:upto]
    assert a.dtype == b.dtype == np.uint8
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("n", [4096 * 3, 4096 * 2 + 100, 512, 64])
@pytest.mark.parametrize("kind", ["mixed", "dense6", "sparse", "empty"])
def test_compact_bytes6_wordsum_matches_jax(n, kind):
    """The word-sum compaction from byte planes: bytes in [0, total),
    and the words_out form (int32 words, little-endian bytes)."""
    staging, lens = _staging(n, kind, n * 7 + len(kind))
    cap = ((n * K + 3) // 4) * 4
    planes = staging.T.copy()
    want = jcompact.compact_bytes6_wordsum(jnp.asarray(planes),
                                           jnp.asarray(lens), cap)
    got = compact.compact_bytes6_wordsum(torch.from_numpy(planes),
                                         torch.from_numpy(lens), cap)
    assert got[0].shape == (cap,)
    _same(got, want, int(lens.sum()))
    words, total = compact.compact_bytes6_wordsum(
        torch.from_numpy(planes), torch.from_numpy(lens), cap, words_out=True)
    jwords, _ = jcompact.compact_bytes6_wordsum(
        jnp.asarray(planes), jnp.asarray(lens), cap, words_out=True)
    assert words.dtype == torch.int32 and words.shape == (cap // 4,)
    t = int(total)
    np.testing.assert_array_equal(words.numpy().view(np.uint8)[:t],
                                  np.asarray(jwords).view(np.uint8)[:t])


@pytest.mark.parametrize("n", [4096 * 3, 4096 * 2 + 100, 512, 64])
@pytest.mark.parametrize("kind", ["mixed", "sparse"])
def test_compact_bytes6_both_tiers_match_jax(n, kind):
    """The segment-sort tier (N a multiple of 4096, two segments or
    more) and the global-sort fallback: the whole buffer equal, at a
    capacity below, at and above N*K."""
    staging, lens = _staging(n, kind, n + 1)
    planes = staging.T.copy()
    for cap in (n * K, n * K + 40, int(lens.sum()) + 3):
        want = jcompact.compact_bytes6(jnp.asarray(planes), jnp.asarray(lens),
                                       cap)
        got = compact.compact_bytes6(torch.from_numpy(planes),
                                     torch.from_numpy(lens), cap)
        assert got[0].shape == (cap,)
        _same(got, want)


@pytest.mark.parametrize("seg", [64, 128])
def test_compact_bytes6_seg_widths_match_jax(seg):
    """An explicit segment width, so that both tiers run at small N."""
    staging, lens = _staging(seg * 4, "mixed", seg)
    planes = staging.T.copy()
    for n in (seg * 4, seg * 4 - 3):
        want = jcompact.compact_bytes6(jnp.asarray(planes[:, :n]),
                                       jnp.asarray(lens[:n]), n * K, seg=seg)
        got = compact.compact_bytes6(torch.from_numpy(planes[:, :n].copy()),
                                     torch.from_numpy(lens[:n]), n * K,
                                     seg=seg)
        _same(got, want)


@pytest.mark.parametrize("n", [1, 64, 513, 4096 * 2 + 100])
@pytest.mark.parametrize("kind", ["mixed", "dense6", "sparse", "empty"])
def test_compact_bytes_and_scatter_match_jax(n, kind):
    """The stable sort and the scatter: the whole buffer equal, with the
    capacity above and below the stream's length."""
    staging, lens = _staging(n, kind, n * 3 + len(kind))
    total = int(lens.sum())
    for cap in (n * K + 8, max(total - 5, 0)):
        args = (staging, lens, cap)
        _same(compact.compact_bytes(*map(_t, args)),
              jcompact.compact_bytes(*map(_j, args)))
        _same(compact.compact_bytes_scatter(*map(_t, args)),
              jcompact.compact_bytes_scatter(*map(_j, args)))


@pytest.mark.parametrize("n", [1, 7, 64, 333])
@pytest.mark.parametrize("kind", ["mixed", "dense6", "sparse"])
def test_compact_merge_and_hybrid_match_jax(n, kind):
    """Merge doubling by barrel shifts (odd row counts carry the last row
    down) and the hybrid's windowed add, at widths that stop early and
    late."""
    staging, lens = _staging(n, kind, n + len(kind))
    _same(compact.compact_bytes_merge(_t(staging), _t(lens)),
          jcompact.compact_bytes_merge(_j(staging), _j(lens)))
    cap = int(lens.sum()) + 16
    for stop in (3072, 24):
        _same(compact.compact_bytes_hybrid(_t(staging), _t(lens), cap,
                                           width_stop=stop),
              jcompact.compact_bytes_hybrid(_j(staging), _j(lens), cap,
                                            width_stop=stop))


def test_barrel_shift_matches_jax():
    rng = np.random.default_rng(5)
    x = rng.integers(0, 256, size=(9, 16), dtype=np.uint8)
    shift = rng.integers(0, 9, size=(9,)).astype(np.int32)
    got = compact._barrel_shift_right(_t(x), _t(shift), max_shift=8)
    want = jcompact._barrel_shift_right(_j(x), _j(shift), max_shift=8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _t(a):
    return torch.from_numpy(np.asarray(a).copy()) if not isinstance(a, int) \
        else a


def _j(a):
    return jnp.asarray(a) if not isinstance(a, int) else a
