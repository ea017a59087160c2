"""Parallel chunk tokenization by finite-state-machine composition (port
of qoi_tpu/ops/fsm.py).

A chunk's byte length is a pure function of its first byte (qoi.h:547-575),
so "is byte i a chunk start?" is a 5-state FSM over the byte stream (state
= bytes remaining until the next chunk start). Each byte's transition is a
map {0..4} -> {0..4}, packed base-8 into one integer; maps compose
associatively, so one scan resolves every state: `fsm_scan`, the CUDA
kernel of kernels/blocked_scan.py on the card.
"""
from __future__ import annotations

import torch

# the FSM's leaf and combine live beside the scan kernel that builds and
# composes them (kernels/blocked_scan.py); tiled_decode composes the
# ranks' maps on the host with them
from ..kernels.blocked_scan import (  # noqa: F401
    _compose_maps, _pack_map, chunk_byte_len, fsm_scan)


def chunk_starts_and_state(data: torch.Tensor, chunks_len):
    """(starts, state_before) over the byte stream. data: (M,) uint8 chunk
    bytes (may include the trailer and padding); positions >= chunks_len
    are never marked, the reference's `p < chunks_len` read guard
    (qoi.h:544).

    Returns ((M,) bool starts, (M,) int8 state_before): how many bytes of
    the current chunk still precede position i (0 = i starts a chunk).
    The streamed decoder ends its tiles at chunk boundaries with it."""
    after = fsm_scan(data)
    # state BEFORE byte i = state after byte i-1 (0 before byte 0)
    state_before = torch.cat([after.new_zeros(1),
                              (after & 7)[:-1]]).to(torch.int8)
    io = torch.arange(data.shape[0], device=data.device)
    return (state_before == 0) & (io < chunks_len), state_before


def chunk_starts(data: torch.Tensor, chunks_len) -> torch.Tensor:
    """(M,) bool chunk-start mask (see chunk_starts_and_state)."""
    return chunk_starts_and_state(data, chunks_len)[0]
