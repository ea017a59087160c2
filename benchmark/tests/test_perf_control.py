"""The control (the reference at 7 bits a channel in the program's place)
comes out not correct, where the program on the same inputs is correct:
at a small size on the CPU; the chip's readings at the cells' own size
are in PERF.md."""
import pytest

from benchmark import control
from conftest import SMALL


@pytest.mark.parametrize("seed", [1, 2**31 + 7, 10**12 + 3])
@pytest.mark.parametrize("workload", ["capture4k-encode", "texture4k-decode",
                                      "capture4k-decode"])
def test_control_fails_program_passes(workload, seed):
    r = control.readings(workload, seed, "cpu", overrides=SMALL)
    assert r["program"]["correct"]
    assert all(v == 0 for v, _ in r["program"]["checks"].values())
    assert not r["control"]["correct"]
    name = "bytes_off" if workload.endswith("encode") else "px_off"
    value, limit = r["control"]["checks"][name]
    assert value > 3 * max(limit, 1)
