"""Pointer-doubling resolution of additive copy-chains (port of
qoi_tpu/ops/link.py), a stage of the v1 decoder.

After tokenization and INDEX-target resolution every decoded chunk's value
is, per channel,

    value[i, c] = anchored[i, c] ? anchor[i, c]
                                 : value[parent[i, c], c] + delta[i, c]

(mod 256): a forest of additive chains. Each round gathers the parents'
state over the whole (N, C) forest and either finishes a node whose parent
is done or doubles its pointer, so a chain of length L resolves in
O(log L) rounds. The round loop runs in Python and reads `done.all()` to
the host once a round, as the JAX `while_loop` tests it once a round.
Pointers are int32 (N < 2**31) and payloads uint8, whose adds wrap mod 256.
"""
from __future__ import annotations

from typing import Tuple

import torch


def resolve(parent: torch.Tensor, delta: torch.Tensor,
            anchored: torch.Tensor, anchor: torch.Tensor,
            root_val: torch.Tensor) -> torch.Tensor:
    """Resolve all chain values by pointer doubling.

    parent: (N, C) int32 parent node per channel, -1 the virtual root;
    delta: (N, C) uint8 added on top of the parent; anchored: (N, C) bool,
    the channel's value is known exactly; anchor: (N, C) uint8, that
    value; root_val: (C,) uint8, the virtual root's value (the seed px).

    Returns (N, C) uint8 resolved values."""
    n, c = parent.shape
    dev = parent.device
    # node n is the virtual root: done, value root_val, its own parent
    p = torch.cat([torch.where(parent < 0, n, parent).to(torch.int32),
                   torch.full((1, c), n, dtype=torch.int32, device=dev)])
    acc = torch.cat([delta, delta.new_zeros((1, c))])
    done = torch.cat([anchored, anchored.new_ones((1, c))])
    val = torch.cat([torch.where(anchored, anchor, 0).to(torch.uint8),
                     torch.as_tensor(root_val, dtype=torch.uint8,
                                     device=dev)[None]])
    while not bool(done.all()):
        pdone = done.gather(0, p)
        pval = val.gather(0, p)
        pacc = acc.gather(0, p)
        pp = p.gather(0, p)
        hop = ~done & pdone        # parent resolved: finish here
        jump = ~done & ~pdone      # both pending: double the pointer
        val = torch.where(hop, pval + acc, val)
        done = done | pdone
        acc = torch.where(jump, acc + pacc, acc)
        p = torch.where(jump, pp, p)
    return val[:n]


def resolve_roots(parent: torch.Tensor, delta: torch.Tensor,
                  done0: torch.Tensor, n_extra: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pointer doubling that reports the reached root instead of a value.

    Nodes 0..N-1 are real; nodes N..N+n_extra-1 are caller-defined roots,
    already done (the incoming-state symbols of a sharded decode).
    `parent` may point at any node, real or extra; -1 maps to extra node 0.
    parent: (N, C) int32; delta: (N, C) uint8; done0: (N, C) bool marks
    the real nodes that are roots themselves.

    Returns (root (N, C) int32 in [0, N + n_extra), acc (N, C) uint8):
    value = base_value(root) + acc (mod 256), base_value of a done real
    node its own value and of an extra node the caller's symbol value."""
    n, c = parent.shape
    dev = parent.device
    io = torch.arange(n + n_extra, dtype=torch.int32, device=dev)[:, None]
    p = torch.cat([torch.where(parent < 0, n, parent).to(torch.int32),
                   io[n:].expand(n_extra, c)])
    # invariant: value(i) = value(p[i]) + acc[i]; for a done i, p[i] is its
    # root and acc[i] the path sum (0 for a root itself)
    acc = torch.cat([torch.where(done0, 0, delta).to(torch.uint8),
                     delta.new_zeros((n_extra, c))])
    done = torch.cat([done0, done0.new_ones((n_extra, c))])
    # done nodes point at themselves, so the reached root is the node
    p = torch.where(done, io, p)
    while not bool(done.all()):
        pdone = done.gather(0, p)
        pacc = acc.gather(0, p)
        pp = p.gather(0, p)
        jump = ~done
        # p[q] of a done parent q is its root and acc[q] its path sum, so
        # one more hop lands on the root with the full path sum
        acc = torch.where(jump, acc + pacc, acc)
        p = torch.where(jump, pp, p)
        done = done | (jump & pdone)
    return p[:n], acc[:n]
