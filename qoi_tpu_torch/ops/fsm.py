"""Parallel chunk tokenization by finite-state-machine composition (port
of qoi_tpu/ops/fsm.py).

A chunk's byte length is a pure function of its first byte (qoi.h:547-575),
so "is byte i a chunk start?" is a 5-state FSM over the byte stream (state
= bytes remaining until the next chunk start). Each byte's transition is a
map {0..4} -> {0..4}, packed base-8 into one integer; maps compose
associatively, so one scan resolves every state.
"""
from __future__ import annotations

import torch

from .. import format as fmt
from .scans import assoc_scan

_NSTATES = 5


def chunk_byte_len(b: torch.Tensor) -> torch.Tensor:
    """Chunk length implied by a first byte (reference qoi.h:547-575)."""
    b = b.to(torch.int64)
    return torch.where(b == fmt.OP_RGB, 4,
           torch.where(b == fmt.OP_RGBA, 5,
           torch.where((b & fmt.MASK_2) == fmt.OP_LUMA, 2, 1)))


def _pack_map(f0: torch.Tensor) -> torch.Tensor:
    """Pack the 5-state map [f0, 0, 1, 2, 3] into base-8 digits: digit s
    holds f(s). Only state 0's transition depends on the byte."""
    const = 0
    for s in range(1, _NSTATES):
        const |= (s - 1) << (3 * s)
    return f0.to(torch.int64) | const


def _compose_maps(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """b after a: c[s] = b[a[s]], on base-8-packed maps (elementwise)."""
    c = torch.zeros_like(a)
    for s in range(_NSTATES):
        a_s = (a >> (3 * s)) & 7
        c = c | (((b >> (3 * a_s)) & 7) << (3 * s))
    return c


def chunk_starts(data: torch.Tensor, chunks_len) -> torch.Tensor:
    """(M,) bool chunk-start mask over the byte stream. data: (M,) uint8
    chunk bytes (may include the trailer and padding); positions >=
    chunks_len are never marked, the reference's `p < chunks_len` read
    guard (qoi.h:544)."""
    trans = _pack_map(chunk_byte_len(data) - 1)
    after = assoc_scan(_compose_maps, trans)
    # state BEFORE byte i = state after byte i-1 (0 before byte 0)
    state_before = torch.cat([after.new_zeros(1), (after & 7)[:-1]])
    io = torch.arange(data.shape[0], device=data.device)
    return (state_before == 0) & (io < chunks_len)
