"""The port's corpus generator (qoi_tpu_torch/utils/make_corpus.py) against
tools/make_corpus.py: the same specs in the same order, names with .qoi
for .png, the same shapes and pixels (tests/test_torch_make_corpus_job.py
holds what `build` writes and runs the corpus job over it).
"""
import pathlib
import sys

import numpy as np
import pytest

from qoi_tpu_torch.utils import make_corpus
from torch_testutil import oracle_built

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

pytestmark = pytest.mark.usefixtures("oracle_built")


@pytest.mark.parametrize("which", ["full", "small"])
def test_specs_match_tools_make_corpus(which):
    """Names (folder kept, .png -> .qoi), order, shapes and pixels, one
    image at a time against the eager JAX list."""
    from tools import make_corpus as jmake

    want = jmake._full_specs() if which == "full" else jmake._small_specs()
    got = make_corpus.full_specs() if which == "full" \
        else make_corpus.small_specs()
    n = 0
    for (name, make), (jname, jimg) in zip(got, want):
        assert name == jname[:-len(".png")] + ".qoi"
        img = make()
        assert img.dtype == jimg.dtype and img.shape == jimg.shape, name
        assert np.array_equal(img, jimg), name
        n += 1
    assert n == len(want) == (303 if which == "full" else 32)
    assert next(got, None) is None
