"""The small corpus of qoi_tpu_torch/utils/make_corpus.py as its command
line writes it (the oracle's streams of its specs), and the port's
corpus job over it on the CPU with the oracle gate: every encode the
oracle's bytes, every roundtrip the same pixels.
"""
import pytest

from qoi_tpu_torch import corpus, oracle
from qoi_tpu_torch.io import image_desc
from qoi_tpu_torch.utils import make_corpus
from torch_testutil import oracle_built

pytestmark = pytest.mark.usefixtures("oracle_built")


@pytest.fixture(scope="module")
def small_root(tmp_path_factory):
    """The small corpus, written once by the module's command line."""
    root = tmp_path_factory.mktemp("qoi_corpus_small")
    assert make_corpus.main([str(root), "--small"]) == 0
    return root


def test_build_writes_the_oracle_streams(small_root, capsys):
    """Each file is oracle.encode of its spec's image; build returns the
    count and prints the total Mpx."""
    files = sorted(p.relative_to(small_root).as_posix()
                   for p in small_root.glob("**/*.qoi"))
    specs = dict(make_corpus.small_specs())
    assert files == sorted(specs)
    mpx = 0
    for name, make in specs.items():
        img = make()
        assert (small_root / name).read_bytes() == oracle.encode(
            img, image_desc(img)), name
        mpx += img.shape[0] * img.shape[1]
    root = small_root.parent / "again"
    assert make_corpus.build(root, small=True) == 32
    assert capsys.readouterr().out == f"total {mpx / 1e6:.1f} Mpx\n"
    assert make_corpus.main([]) == 2


@pytest.mark.parametrize("folder", ["icons", "hard"])
def test_run_job_over_small_corpus_folders(small_root, folder):
    """The corpus job with the oracle gate on the CPU over the small
    corpus's icons and hard members (1xN, Nx1, ~5 B/px noise)."""
    c = corpus.run_job(small_root / folder, "roundtrip", oracle_verify=True,
                       device="cpu", progress=lambda m: None)
    assert c.images == len(list((small_root / folder).glob("*.qoi")))
    assert c.images >= 4 and c.verify_failures == 0


@pytest.mark.slow
def test_run_job_over_small_corpus(small_root):
    """The whole small corpus (32 images, 11.7 Mpx; ~60 s on a CPU: each
    file decodes twice through the plain twins)."""
    c = corpus.run_job(small_root, "roundtrip", oracle_verify=True,
                       device="cpu", progress=lambda m: None)
    assert c.images == 32 and c.verify_failures == 0
    assert c.pixels == 11_687_786
