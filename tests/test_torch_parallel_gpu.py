"""The sequence-parallel codec on the card: a 4K frame encoded and decoded
by S = 4 gloo ranks that share cuda:0 (a machine with one card), against
the C++ oracle, with the staging and compact_words kernels launched by every
rank; and the byte-plane word-sum compaction on the card against its CPU
result.

These tests need a CUDA device and skip without one. Run them on the GPU
machine (which need not have jax) with:

    python -m pytest --noconftest -m gpu -q tests/test_torch_parallel_gpu.py
"""
import numpy as np
import pytest
import torch

from qoi_tpu_torch import format as fmt
from qoi_tpu_torch import oracle
from qoi_tpu_torch.kernels import _build
from qoi_tpu_torch.ops import compact
from qoi_tpu_torch.parallel.launch import RankPool
from qoi_tpu_torch.utils import testimages

import torch_parallel_tasks as tasks

pytestmark = pytest.mark.gpu

S = 4


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    _build.build()      # once here, not in every rank
    return torch.device("cuda", 0)


@pytest.mark.parametrize("kind", ["mixed", "photo_rgb"])
def test_tiled_4k_on_card(dev, kind):
    """Every rank returns the oracle's stream and the source pixels, the
    sharded fixpoint converges on every shard, and each rank launched
    compact_words in its tile's compaction."""
    img = (testimages.mixed(3840, 2160, 4, seed=3) if kind == "mixed"
           else testimages.photo(3840, 2160, 3, seed=3))
    h, w, ch = img.shape
    stream = oracle.encode(img, fmt.StreamDesc(w, h, ch))
    with RankPool(S, device="cuda", timeout_s=600) as pool:
        res = pool.run(tasks.roundtrip_on_card, img, stream)
    for r, (same_stream, same_px, conv, launches, stats) in enumerate(res):
        assert same_stream and same_px, f"rank {r}"
        assert conv, f"rank {r}: the sharded fixpoint did not converge"
        assert launches["compact_words"] > 0, f"rank {r}: {launches}"
        assert launches["encode_stage_words"] > 0, f"rank {r}: {launches}"


@pytest.mark.parametrize("n,kind", [(4096 * 3, "mixed"), (4096 * 2 + 100,
                                                          "dense6"),
                                    (20480 * 2 + 5, "sparse")])
def test_compact_bytes6_wordsum_on_card_matches_cpu(dev, n, kind):
    rng = np.random.default_rng(n)
    staging = rng.integers(1, 256, size=(6, n), dtype=np.uint8)
    lens = {"mixed": lambda: rng.integers(0, 7, n),
            "dense6": lambda: np.full(n, 6),
            "sparse": lambda: np.where(rng.random(n) < 0.05,
                                       rng.integers(1, 7, n), 0)}[kind]()
    cap = -(-n * 6 // 4) * 4
    st, ln = torch.from_numpy(staging), torch.from_numpy(lens)
    k0 = _build.launches["compact_words"]
    got, tg = compact.compact_bytes6_wordsum(st.to(dev), ln.to(dev), cap)
    torch.cuda.synchronize()
    assert _build.launches["compact_words"] == k0 + 1
    want, tc = compact.compact_bytes6_wordsum(st, ln, cap)
    assert int(tg) == int(tc) == lens.sum()
    t = int(tc)
    assert torch.equal(got.cpu()[:t], want[:t])
