"""Engine configuration: the port's own copy of qoi_tpu/config.py.

One dataclass covers the engine tunables; CLI tools map their argv onto
it, and the facade and io resolve it (io._as_config, io._engine). The
port reads `engine` and `verify` (io.write/read), `stream_tile_px`
(models/streamed.py), and `decode_max_iters` and `bucket_floor`
(models/decode_v3.decode, models/streamed.py, models/pipeline.encode).
`table_block` is accepted and has no effect: it is the width of the JAX
package's brute-force table (qoi_tpu/models/pipeline.py), while the
port's table (ops/table.py) is sort-based and gives the same output for
every width. `mesh` = (data, seq) selects the sequence-parallel codec
(parallel/), which needs an initialized process group of data*seq
ranks. The fields are kept so that a configuration means the same in
both packages.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Tunables for the codec engine."""

    # which codec drives encode/decode: "tpu" (parallel pipeline),
    # "scan" (sequential anchor), "oracle" (C++ host codec)
    engine: str = "tpu"

    # verify every encode/decode differentially against the oracle
    verify: bool = False

    # shape-bucketing floor
    bucket_floor: int = 256

    # within-block brute-force width of qoi_tpu/ops/table.py (<= 127);
    # validated, without effect on the port's sort-based table
    table_block: int = 64

    # models/streamed.py tile size (pixels for encode, bytes for decode);
    # the facade passes it to the streamed drivers
    stream_tile_px: int = 1 << 22

    # decode fixpoint iteration cap before the sequential fallback
    # (models/decode_v3.decode, models/streamed.decode)
    decode_max_iters: int = 12

    # (data, seq) mesh shape; None = single device
    mesh: Optional[Tuple[int, int]] = None

    def validate(self) -> None:
        if self.engine not in ("tpu", "scan", "oracle"):
            raise ValueError(f"unknown engine {self.engine!r}")
        if not 1 <= self.table_block <= 127:
            raise ValueError("table_block must be in [1, 127]")
        if self.bucket_floor < 1 or self.stream_tile_px < 2:
            raise ValueError("bad bucket_floor / stream_tile_px")
        if self.mesh is not None and (self.mesh[0] < 1 or self.mesh[1] < 1):
            raise ValueError(f"bad mesh {self.mesh}")


DEFAULT = EngineConfig()
