"""Scan-shaped primitives: run segmentation, prefix sums and a generic
associative scan (port of qoi_tpu/ops/scans.py).

The JAX package routes its big cumulative ops through `blocked_scan`, a
`lax.scan` over position-in-block shaped for the TPU's vector unit.
PyTorch has `cumsum` on every device, `assoc_scan` below covers the
custom combines with log-depth doubling, and the cumulative maxes the
port's callers take are `last_true_index`, a count and a scatter
(`cummax` is the general form).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .. import format as fmt


def exclusive_cumsum(x: torch.Tensor) -> torch.Tensor:
    """Exclusive prefix sum over the last axis, in int64."""
    x = x.to(torch.int64)
    return torch.cumsum(x, dim=-1) - x


def assoc_scan(combine, elems):
    """Inclusive scan over the last axis of a tensor or a tuple of
    tensors, by log-depth doubling (Hillis-Steele). `combine(earlier,
    later)` keeps the JAX argument order, so non-commutative combines
    (map composition, affine recurrences) come out as `blocked_scan`'s."""
    single = isinstance(elems, torch.Tensor)
    xs = (elems,) if single else tuple(elems)
    n = xs[0].shape[-1]
    k = 1
    while k < n:
        early = tuple(x[..., :-k] for x in xs)
        late = tuple(x[..., k:] for x in xs)
        c = combine(early[0], late[0]) if single else combine(early, late)
        c = (c,) if single else tuple(c)
        xs = tuple(torch.cat([x[..., :k], y], dim=-1) for x, y in zip(xs, c))
        k <<= 1
    return xs[0] if single else xs


def cummax(x: torch.Tensor) -> torch.Tensor:
    """Inclusive cumulative max over the last axis (the JAX package's
    `scans.cummax`). torch's int64 cummax took 73 ms of a 94 ms 4K encode
    on an H100, so no caller of the port takes this general form where
    its marked values rise with position: there `last_true_index` of the
    mark plus one gather gives the same. That covers every caller:
    `decode_pipeline._initial_hashes` (the last RGBA literal) and the run
    expansion marks of `decode_pipeline._decode_chunks` and
    `decode_v2._expand` (`last_mark`)."""
    return torch.cummax(x, dim=-1).values


def last_mark(marks: torch.Tensor) -> torch.Tensor:
    """cummax of a (N,) int64 array whose values >= 0 rise with position
    and whose other entries are -1: the marked value at the last mark at
    or before each i, else -1. One `last_true_index` and one gather."""
    last = last_true_index(marks >= 0)
    return torch.where(last >= 0, marks[last.clamp(min=0)], -1)


def last_true_index(mask: torch.Tensor) -> torch.Tensor:
    """For each i of the (N,) mask, the largest j <= i with mask[j], else
    -1. The JAX package takes a cumulative max of where(mask, i, -1); here
    the trues are counted instead (torch's int64 cummax took ~24 ms at
    8.4 M elements on an H100): the k-th true's position is scattered to
    slot k, and each i reads slot count(trues <= i)."""
    n = mask.shape[0]
    io = torch.arange(n, device=mask.device)
    cnt = torch.cumsum(mask, dim=0)
    pos = torch.full((n + 1,), -1, dtype=torch.int64, device=mask.device)
    # falses all write -1 to slot 0, so their order does not matter
    pos.scatter_(0, torch.where(mask, cnt, 0), torch.where(mask, io, -1))
    return pos[cnt]


class RunInfo(NamedTuple):
    """Per-pixel run bookkeeping. All arrays share the input's shape."""

    emits_run: torch.Tensor   # bool: this eq-pixel emits a RUN chunk here
    run_val: torch.Tensor     # int64: RUN length emitted (valid iff emits_run)
    flush: torch.Tensor       # bool: literal pixel preceded by a pending run
    flush_val: torch.Tensor   # int64: pending run length (valid iff flush)


def run_segmentation(eq: torch.Tensor, last_pos=None, run_in=None,
                     resets=None) -> RunInfo:
    """Resolve every RUN-chunk emission point from the (N,) equality mask
    (eq[i]: pixel i equals pixel i-1, pixel -1 being the seed or the
    incoming boundary pixel). A RUN is emitted when the run reaches 62 or
    at the last pixel (qoi.h:417); a pending run is flushed before any
    literal (qoi.h:425-428).

    `last_pos` overrides the index of the stream's final pixel (default
    n-1; -1 for "not in this tile"); `run_in` (int in [0, 61]) is the
    pending run length entering the tile. `resets` (port only; (N,) bool)
    marks positions before which the pending run is cut to 0, as the
    fused staging kernel cuts it at block starts after the final pixel:
    a run restarts there as after a literal, and nothing is flushed."""
    n = eq.shape[-1]
    io = torch.arange(n, device=eq.device)
    last_noneq = last_true_index(~eq)
    if resets is not None:
        last_noneq = torch.maximum(last_noneq, last_true_index(resets) - 1)
    run_in = torch.as_tensor(0 if run_in is None else run_in,
                             dtype=torch.int64, device=eq.device)
    # the leading all-eq prefix continues the incoming pending run
    run_pos = io - last_noneq + torch.where(last_noneq == -1, run_in, 0)
    is_last = io == (n - 1 if last_pos is None else last_pos)
    emits_run = eq & ((run_pos % fmt.RUN_CAP == 0) | is_last)
    run_val = (run_pos - 1) % fmt.RUN_CAP + 1

    prev_eq = torch.cat([(run_in > 0).reshape(1), eq[:-1]])
    if resets is not None:
        prev_eq = prev_eq & ~resets
    prev_run_pos = torch.cat([run_in.reshape(1), run_pos[:-1]])
    flush = ~eq & prev_eq & (prev_run_pos % fmt.RUN_CAP != 0)
    flush_val = (prev_run_pos - 1) % fmt.RUN_CAP + 1
    return RunInfo(emits_run, run_val, flush, flush_val)
