"""The full-corpus conformance gate on the card (the port's counterpart of
tests/test_corpus_full.py): the 303-image corpus of
qoi_tpu_torch/utils/make_corpus.py, written as the oracle's .qoi streams,
through the port's corpus job on the card with both gates -- every
encode byte-identical to the C++ oracle and every roundtrip
pixel-identical -- over hash-collision palettes, ~5 B/px noise, 1xN and
Nx1 extremes and the members on both sides of the 16 Mpx streaming
switch. Then the bucketed batch API over the same images and streams,
held to the oracle's bytes and the source pixels.

It needs a CUDA device and skips without one; run it on the GPU machine
(which need not have jax) with:

    python -m pytest --noconftest -m gpu -q tests/test_torch_corpus_full_gpu.py
"""
import numpy as np
import pytest
import torch

from qoi_tpu_torch import corpus, oracle
from qoi_tpu_torch.io import image_desc
from qoi_tpu_torch.models import batch
from qoi_tpu_torch.utils import make_corpus

pytestmark = [pytest.mark.gpu, pytest.mark.slow]


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def test_full_corpus_roundtrip_oracle_exact(dev, tmp_path_factory):
    root = tmp_path_factory.mktemp("qoi_corpus_full")
    n = make_corpus.build(root)
    assert n == 303
    c = corpus.run_job(root, "roundtrip", oracle_verify=True, device=dev,
                       progress=lambda m: None)
    assert c.images == n
    assert c.verify_failures == 0
    assert c.pixels >= 150_000_000


def test_full_corpus_through_the_batch_api(dev):
    """encode_batch and decode_batch over every image of the corpus, a
    folder a call (the batch API takes the 17.28 Mpx member whole): the
    oracle's bytes, the sources' pixels."""
    folders = {}
    for name, make in make_corpus.full_specs():
        folders.setdefault(name.split("/")[0], []).append(make())
    assert sum(map(len, folders.values())) == 303
    for folder, imgs in folders.items():
        want = [oracle.encode(im, image_desc(im)) for im in imgs]
        got = batch.encode_batch(imgs, device=dev)
        bad = [i for i, (g, w) in enumerate(zip(got, want)) if g != w]
        assert bad == [], f"{folder}: encode_batch differs at {bad}"
        res = batch.decode_batch(want, device=dev)
        bad = [i for i, ((px, _, err), im) in enumerate(zip(res, imgs))
               if err is not None or not np.array_equal(px, im)]
        assert bad == [], f"{folder}: decode_batch differs at {bad}"
