"""The reference encoder against the port's oracle (qoi.h's bytes)."""
import numpy as np
import pytest
import torch

from benchmark import frames, reference
from qoi_tpu_torch import format as fmt
from qoi_tpu_torch import oracle
from qoi_tpu_torch.utils import testimages


def _cases():
    cases = dict(testimages.edge_case_suite(4))
    cases["palette_collide"] = testimages.palette_collide(40, 30, 4)
    cases["palette_alpha"] = testimages.palette_alpha(50, 40)
    zeros = np.zeros((5, 7, 4), np.uint8)  # (0,0,0,0) hits the empty slot 0
    zeros[0, 3] = (1, 2, 3, 4)
    cases["transparent_black"] = zeros
    run = np.zeros((1, 200, 4), np.uint8)  # the seed pixel starts a run
    run[..., 3] = 255
    cases["seed_run_200"] = run
    for n in (61, 62, 63, 124, 125):  # runs at and around the 62 cap
        img = np.tile(np.array([[[9, 8, 7, 255]]], np.uint8), (1, n + 2, 1))
        img[0, -1] = (1, 2, 3, 255)
        cases[f"run_{n}"] = img
    return cases


@pytest.mark.parametrize("name", sorted(_cases()))
def test_reference_bytes_equal_oracle(name):
    img = _cases()[name]
    h, w = img.shape[:2]
    want = oracle.encode(img, fmt.StreamDesc(w, h, 4))
    got = reference.encode(torch.from_numpy(img.reshape(-1, 4).copy()), w, h)
    assert got == want


@pytest.mark.parametrize("alpha", frames.ALPHAS)
@pytest.mark.parametrize("seed", [0, 7, 2**31 + 11])
def test_reference_bytes_equal_oracle_on_frames(alpha, seed):
    w, h = 97, 29
    px = frames.frame(w, h, seed, alpha)
    want = oracle.encode(px.reshape(h, w, 4).numpy(), fmt.StreamDesc(w, h, 4))
    assert reference.encode(px, w, h) == want


def test_reference_body_is_stream_without_header_and_trailer():
    px = frames.frame(33, 17, 5)
    body = reference.encode_body(px).numpy().tobytes()
    stream = reference.encode(px, 33, 17)
    assert stream[:fmt.HEADER_SIZE] == fmt.pack_header(fmt.StreamDesc(33, 17, 4))
    assert stream[fmt.HEADER_SIZE:-fmt.TRAILER_SIZE] == body
    assert stream[-fmt.TRAILER_SIZE:] == fmt.TRAILER


def test_seven_bit_control_changes_the_bytes():
    px = frames.frame(64, 48, 3)
    assert not torch.equal(reference.encode_body(reference.seven_bit(px)),
                           reference.encode_body(px))
