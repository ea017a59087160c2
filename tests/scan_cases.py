"""Inputs of the sequential codec kernels' tests: the design emulation on
the CPU (tests/test_torch_scan_designs.py) and the kernels on the card
(tests/test_torch_kernels_gpu.py). numpy and the port only, no JAX."""
import numpy as np

from qoi_tpu_torch import format as fmt
from qoi_tpu_torch import oracle
from qoi_tpu_torch.utils import testimages

SEED = 0xFF000000


def slot_of(p):
    return ((p & 0xFF) * 3 + ((p >> 8) & 0xFF) * 5 + ((p >> 16) & 0xFF) * 7
            + (p >> 24) * 11) & 63


def random_state(seed):
    """A random (65,) int32 entry state: px and 64 slots."""
    rng = np.random.default_rng(seed)
    return rng.integers(-2**31, 2**31, 65).astype(np.int32)


def body_of(img):
    """The oracle stream of img, from its first chunk byte."""
    h, w, ch = img.shape
    return oracle.encode(img, fmt.StreamDesc(w, h, ch))[fmt.HEADER_SIZE:]


def edge_stream():
    """Chunks over the walk's window edges (a window starts where the last
    one's last chunk ended): an RGBA chunk over bytes 29-33, past the first
    window; a RUN at the last position of the second (byte 65); an INDEX
    chain of 40 over the third window's edge; LUMA chunks, then INDEX
    chains and long runs."""
    b = [0x40 | 0x2A] * 29                  # DIFF (0, 0, 0)
    b += [fmt.OP_RGBA, 10, 20, 30, 40]      # bytes 29-33
    b += [0x05] * 31 + [fmt.OP_RUN | 40]    # bytes 34-64, the RUN at 65
    b += [0x05] * 40                        # bytes 66-105
    b += [0x80 | 30, 0x95] * 20             # LUMA
    b += [0x00, 0x3F, 0x05, 0x11] * 10      # INDEX chains
    b += [fmt.OP_RUN | 61] * 3
    return bytes(b)


def own_group_index_stream():
    """An INDEX that reads a slot written earlier in its own window: RGBA
    literals whose slots the following INDEX bytes name."""
    out = []
    for v in range(1, 40):
        rgb = (v * 37 & 0xFF, v * 91 & 0xFF, v * 13 & 0xFF)
        slot = slot_of(rgb[0] | rgb[1] << 8 | rgb[2] << 16 | 0xFF << 24)
        out += [fmt.OP_RGBA, *rgb, 0xFF, 0x40 | 0x2A, slot, slot]
    return bytes(out)


def decode_case(case):
    """(data bytes, n_px, chunks_len)."""
    mixed = body_of(testimages.mixed(37, 29, 4, seed=6))
    clen_mixed = len(mixed) - fmt.TRAILER_SIZE
    if case == "adversarial":
        return b"\x05" * 1500 + fmt.TRAILER, 1500, 1500
    if case == "mixed":
        return mixed, 37 * 29, clen_mixed
    if case == "soup":
        rng = np.random.default_rng(12)
        return rng.integers(0, 256, 3000).astype(np.uint8).tobytes(), 4000, \
            2992
    if case.startswith("cut"):
        cut = int(case[3:])
        return mixed[:cut] + fmt.TRAILER, 37 * 29, cut
    if case == "edge":
        s = edge_stream()
        return s + fmt.TRAILER, 900, len(s)
    if case == "own_group_index":
        s = own_group_index_stream()
        return s + fmt.TRAILER, 200, len(s)
    if case == "n_px_below":
        return mixed, 333, clen_mixed
    if case == "n_px_above":
        return mixed, 37 * 29 + 517, clen_mixed
    if case == "chunks_len_0":
        return mixed, 77, 0
    if case == "rgb_photo":
        return body_of(testimages.photo(41, 23, 3, seed=2)), 41 * 23, \
            len(body_of(testimages.photo(41, 23, 3, seed=2))) - 8
    raise ValueError(case)


DECODE_CASES = ["adversarial", "mixed", "soup", "cut11", "cut500", "edge",
                 "own_group_index", "n_px_below", "n_px_above",
                 "chunks_len_0", "rgb_photo"]


def encode_case(case):
    """(N,) u32 packed pixels."""
    if case == "zeros":                 # (0,0,0,0): INDEX 0 of the table
        return np.zeros(300, np.uint32)
    if case in ("run62", "run63"):
        k = int(case[3:])
        a = np.array([0x11223344] * 5 + [SEED] * k + [0x01020304] * (k + 1)
                     + [0x11223344] * 3, np.uint32)
        return a
    if case == "last_in_run":
        return np.array([5, 6, 7] + [9] * 40, np.uint32)
    if case == "one":
        return np.array([0x7F00FF01], np.uint32)
    if case == "seed_run":              # a run from pixel 0 (prev = seed)
        return np.array([SEED] * 70 + [3] + [SEED] * 130, np.uint32)
    imgs = {"mixed": lambda: testimages.mixed(61, 37, 4, seed=5),
            "noise": lambda: testimages.noise(33, 31, 4, seed=3),
            "palette": lambda: testimages.palette(47, 29, 4, colors=9),
            "runs": lambda: testimages.runs_with_caps(130, 8, 4)}
    img = imgs[case]()
    return np.ascontiguousarray(img).reshape(-1, 4).view(np.uint32).reshape(-1)


ENCODE_CASES = ["zeros", "run62", "run63", "last_in_run", "one",
                 "seed_run", "mixed", "noise", "palette", "runs"]
