"""The frame generator: determined by the seed, each palette of its class."""
import pytest
import torch

from benchmark import frames


@pytest.mark.parametrize("alpha", frames.ALPHAS)
def test_same_seed_same_frame(alpha):
    a = frames.frame(96, 40, 2**31 + 3, alpha)
    b = frames.frame(96, 40, 2**31 + 3, alpha)
    assert a.shape == (96 * 40, 4) and a.dtype == torch.uint8
    assert torch.equal(a, b)


def test_other_seed_other_frame():
    assert not torch.equal(frames.frame(96, 40, 1), frames.frame(96, 40, 2))


def test_frame_seeds_distinct_and_in_range():
    seeds = {frames.frame_seed(s, k) for s in (0, 1, 2**40) for k in range(8)}
    assert len(seeds) == 24
    assert all(0 <= s < 2**63 for s in seeds)
    assert frames.frame_seed(5, 3) == frames.frame_seed(5, 3)


@pytest.mark.parametrize("seed", range(20))
@pytest.mark.parametrize("alpha,kind", [
    ("varying", "distinct"), ("varying", "slot_pair"),
    ("varying", "alpha_triple"), ("opaque", "distinct"),
    ("opaque", "slot_pair")])
def test_palette_holds_its_class(seed, alpha, kind):
    pal = frames.palette(seed, alpha, kind)
    h = frames.qoi_hash(pal).tolist()
    a = pal[:, 3].tolist()
    slots = sorted((h.count(x) for x in set(h)), reverse=True)
    alphas = sorted((a.count(x) for x in set(a)), reverse=True)
    assert slots == ([2] + [1] * 6 if kind == "slot_pair" else [1] * 8)
    if alpha == "opaque":
        assert alphas == [8] and a[0] == 255
    else:
        assert alphas == ([3] + [1] * 5 if kind == "alpha_triple"
                          else [1] * 8)


def test_palettes_differ_by_seed():
    pals = {tuple(frames.palette(s, "varying", "alpha_triple").flatten()
                  .tolist()) for s in range(10)}
    assert len(pals) == 10


def test_no_alpha_triple_when_opaque():
    with pytest.raises(ValueError):
        frames.palette(1, "opaque", "alpha_triple")
    with pytest.raises(ValueError):
        frames.palette(1, "varying", "alpha_pair")


def test_regions():
    w, h = 80, 6
    img = frames.frame(w, h, 9, "varying").reshape(h, w, 4)
    q = w // 4
    x = torch.arange(q)
    y = torch.arange(h)[:, None]
    assert torch.equal(img[:, :q, 0].long(), (x + y) % 256)   # gradient
    assert (img[:, q:2 * q] == torch.tensor(frames.FLAT,
                                            dtype=torch.uint8)).all()
    pal = frames.palette(9, "varying")
    seg = img[:, 2 * q:3 * q].reshape(-1, 4)
    assert ((seg[:, None] == pal[None]).all(-1)).any(-1).all()
    opaque = frames.frame(w, h, 9, "opaque")
    assert (opaque[:, 3] == 255).all()


def test_bad_alpha_mode():
    with pytest.raises(ValueError):
        frames.frame(8, 8, 0, "half")


@pytest.mark.gpu
def test_same_seed_same_frame_on_the_card(cuda):
    a = frames.frame(3840, 2160, 2**31 + 5, "varying", cuda)
    b = frames.frame(3840, 2160, 2**31 + 5, "varying", cuda)
    assert a.device.type == "cuda" and torch.equal(a, b)


@pytest.mark.gpu
def test_reference_same_bytes_on_the_card(cuda):
    from benchmark import reference
    px = frames.frame(384, 216, 17, "varying")
    assert torch.equal(reference.encode_body(px.to(cuda)).cpu(),
                       reference.encode_body(px))
