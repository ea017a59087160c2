"""Unsigned 32-bit arithmetic on torch integer tensors.

The JAX package computes in uint32. torch has no full uint32 arithmetic,
and its `>>` on int32 is an arithmetic shift, so the port's plain tensor
code holds u32 values in int64 tensors with values in [0, 2**32) and
masks with `M32` after every `<<`, `+`, `-` and `*` that can leave that
range. The hand-written kernels take and return the same values as int32
bit patterns; `to_i32` and `u32` convert at their boundaries.
"""
from __future__ import annotations

import torch

M32 = 0xFFFFFFFF


def u32(x: torch.Tensor) -> torch.Tensor:
    """Any integer tensor (int32 bit patterns included) -> int64 u32."""
    return x.to(torch.int64) & M32


def to_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 u32 values -> int32 tensor with the same 32-bit pattern."""
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32)


def swar_add(a: torch.Tensor, b) -> torch.Tensor:
    """Per-byte mod-256 add of 4x-u8-packed u32 lanes (masked halves
    keep carries in the zero gaps)."""
    lo = ((a & 0x00FF00FF) + (b & 0x00FF00FF)) & 0x00FF00FF
    hi = ((a & 0xFF00FF00) + (b & 0xFF00FF00)) & 0xFF00FF00
    return lo | hi


def swar_sub(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Per-byte mod-256 subtract of 4x-u8-packed u32 lanes: a guard bit
    above each byte absorbs the borrow."""
    m = 0x00FF00FF
    g = 0x01000100
    lo = (((a & m) | g) - (b & m)) & m
    hi = ((((a >> 8) & m) | g) - ((b >> 8) & m)) & m
    return lo | (hi << 8)
