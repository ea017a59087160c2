"""What an entry module (`benchmark/entries/<name>.py`) gives the harness.

An entry drives one entry point of the program. It defines:

- `prepare(cfg, frames, device) -> state`: the inputs, from the
  configuration and the pool's frames ((N, 4) uint8 tensors on the
  device); counted as set-up;
- `request(state, k) -> Result`: one request on pool item k, run until
  its answer is complete;
- `control_output(state, k)`: the control's answer for item k, in the
  form `request` returns it;
- `check(state, samples) -> {name: (value, limit)}`: the numbers that
  decide `correct`, over [(k, output)] pairs.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple


class Result(NamedTuple):
    output: Any              # the answer, as check() reads it
    ok: bool                 # False: the program reported a failure
    counters: Dict[str, int]  # the program's counts for this request
    bytes_moved: int         # the roofline's bytes: pixels and stream
