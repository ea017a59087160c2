"""QOI bitstream format: constants, header pack/unpack, stream descriptor.

This is the L0 layer of the framework (SURVEY.md §1): the normative facts of
the QOI format, independent of any execution engine. Semantics follow the
reference spec block (qoi.h:61-207).
"""
from __future__ import annotations

import dataclasses
import struct

# ---------------------------------------------------------------------------
# Chunk tags (reference qoi.h:106-207). Two-bit tags occupy the top 2 bits;
# the two 8-bit tags take precedence when matching.
OP_INDEX = 0x00  # 00iiiiii  index into the 64-entry color table
OP_DIFF = 0x40   # 01rrggbb  per-channel delta in [-2, 1], bias +2
OP_LUMA = 0x80   # 10gggggg  green delta in [-32, 31] + dr-dg / db-dg nibbles
OP_RUN = 0xC0    # 11rrrrrr  run of previous pixel, length 1..62, bias -1
OP_RGB = 0xFE    # 11111110  literal r, g, b
OP_RGBA = 0xFF   # 11111111  literal r, g, b, a
MASK_2 = 0xC0

MAGIC = b"qoif"
HEADER_SIZE = 14
TRAILER_SIZE = 8
TRAILER = bytes(7) + b"\x01"  # seven 0x00 then 0x01 (reference qoi.h:103)

# Run lengths 63 and 64 are unrepresentable: those tag bytes are OP_RGB/OP_RGBA
# (reference qoi.h:177-179).
RUN_CAP = 62

# Implementation guard shared with the reference (qoi.h:329-332): cap streams
# at 400M pixels so the worst case (5 B/px + header + trailer) stays < 2 GB.
PIXELS_MAX = 400_000_000

SRGB = 0
LINEAR = 1

# Color-table hash multipliers: slot = (3r + 5g + 7b + 11a) mod 64
# (reference qoi.h:92-94).
HASH_MULTIPLIERS = (3, 5, 7, 11)

# Seed state shared by encoder and decoder (reference qoi.h:74-76): the
# "previous pixel" starts as opaque black; the color table starts all-zero
# *including alpha* (qoi.h:87-89 — distinct from the pixel seed).
SEED_PIXEL = (0, 0, 0, 255)


@dataclasses.dataclass(frozen=True)
class StreamDesc:
    """Image/stream descriptor (reference `qoi_desc`, qoi.h:236-241)."""

    width: int
    height: int
    channels: int  # 3 = RGB, 4 = RGBA
    colorspace: int = SRGB  # informative only; never affects coding

    @property
    def num_pixels(self) -> int:
        return self.width * self.height

    def validate(self) -> None:
        """Raise ValueError on descriptors the reference would reject
        (qoi.h:364-372)."""
        if self.width <= 0 or self.height <= 0:
            raise ValueError(f"bad dimensions {self.width}x{self.height}")
        if self.channels not in (3, 4):
            raise ValueError(f"channels must be 3 or 4, got {self.channels}")
        if self.colorspace not in (SRGB, LINEAR):
            raise ValueError(f"bad colorspace {self.colorspace}")
        # The reference rejects with integer division (qoi.h:369,518):
        # height >= QOI_PIXELS_MAX / width — NOT num_pixels >= PIXELS_MAX.
        # E.g. width=3, height=133333333 (399,999,999 px) is rejected by the
        # reference even though the product is below the cap.
        if self.height >= PIXELS_MAX // self.width:
            raise ValueError(
                f"height {self.height} >= {PIXELS_MAX} // {self.width} "
                f"(reference pixel-count guard)")

    def max_stream_bytes(self) -> int:
        """Worst-case encoded size (reference qoi.h:374-376)."""
        return self.num_pixels * (self.channels + 1) + HEADER_SIZE + TRAILER_SIZE


def pack_header(desc: StreamDesc) -> bytes:
    """14-byte header: magic, BE32 width/height, channels, colorspace
    (reference qoi.h:66-72)."""
    desc.validate()
    return MAGIC + struct.pack(
        ">IIBB", desc.width, desc.height, desc.channels, desc.colorspace
    )


def unpack_header(data: bytes) -> StreamDesc:
    """Parse and validate a stream header; raises ValueError on anything the
    reference decoder rejects (qoi.h:497-521)."""
    if len(data) < HEADER_SIZE + TRAILER_SIZE:
        raise ValueError(f"stream too short: {len(data)} bytes")
    if data[:4] != MAGIC:
        raise ValueError("bad magic")
    width, height, channels, colorspace = struct.unpack(">IIBB", data[4:14])
    desc = StreamDesc(width, height, channels, colorspace)
    desc.validate()
    return desc


def hash_rgba(r: int, g: int, b: int, a: int) -> int:
    """Color-table slot for a pixel (reference qoi.h:92-94)."""
    m = HASH_MULTIPLIERS
    return (r * m[0] + g * m[1] + b * m[2] + a * m[3]) & 63
