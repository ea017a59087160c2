"""Shape buckets for decode buffers: the counterparts of `bucket_size` and
`bucket_size_fine` in qoi_tpu/models/decode_pipeline.py (the rest of that
module, the v1 decoder, is not ported yet)."""
from __future__ import annotations


def bucket_size(n: int, floor: int = 256) -> int:
    """Next power of two >= n (and >= floor)."""
    b = floor
    while b < n:
        b <<= 1
    return b


def bucket_size_fine(n: int, floor: int = 256) -> int:
    """Quarter-power-of-two bucket (2^k * {1, 1.25, 1.5, 1.75}) for sizes
    >= 2^20, at most ~14.3% padding; smaller sizes keep pow2 buckets.
    Every candidate divides the decoder's scan blocks."""
    if n < (1 << 20):
        return bucket_size(n, floor)
    b = 1 << 20
    while b < n:
        b <<= 1
    for frac in (4, 5, 6, 7):
        cand = (b >> 3) * frac
        if cand >= n:
            return cand
    return b
