"""The (data, seq) process mesh and its collectives (port of
qoi_tpu/parallel/sharding.py, on torch.distributed).

The codec has two parallel axes:
  "data" -- independent images;
  "seq"  -- pixel tiles (encode) or byte ranges (decode) of ONE stream,
            whose carries cross tile boundaries as small summaries
            (parallel/tiled.py, parallel/tiled_decode.py).

A mesh is built over an initialized process group of data*seq ranks, seq
innermost as in the JAX package: rank r holds data index r // seq and
seq index r % seq. Each axis is a sub-group (`dist.new_group`) of the
default group, so it uses the default group's backend; a group of
several ranks on one card has to be gloo, since NCCL refuses two ranks on
one device. Rank r computes on `cuda:(r % device_count)`, so on a
one-card machine every rank shares `cuda:0`.

Gloo takes all_gather, all_reduce and reduce_scatter_tensor on CUDA
tensors (torch 2.11 on an H100), so `Axis` hands the tensor to gloo as it
is; a backend that refuses one raises. `Mesh.stats` counts the
collectives and their seconds, and the seconds of the phases the codec
marks.

A mesh is made once for each (ranks, data, seq, device) of the default
process group and reused: its sub-groups are process groups of their own,
which nothing frees before the default group is destroyed.
"""
from __future__ import annotations

import contextlib
import time
from typing import Dict, List, Optional, Sequence

import torch
import torch.distributed as dist

DATA_AXIS = "data"
SEQ_AXIS = "seq"

#: this process's meshes by (ranks, data, seq, device), and the default
#: group they were made over (a new default group drops them)
_meshes: Dict[tuple, Optional["Mesh"]] = {}
_meshes_group = None


def rank_device(device="cuda") -> torch.device:
    """This rank's device: `device` as given, or for a bare "cuda" the card
    `rank % device_count`. Raises without a card, as every entry point of
    the port does."""
    from .. import _device

    dev = _device(device)
    if dev.type == "cuda" and dev.index is None:
        rank = dist.get_rank() if dist.is_initialized() else 0
        dev = torch.device("cuda", rank % torch.cuda.device_count())
    return dev


class Stats:
    """Counters of one mesh: collectives run, their seconds (each
    bracketed by device synchronizations) and every call as (collective,
    input bytes, seconds), seconds of the phases the codec marks
    (`phase`) and the rounds of each decode fixpoint."""

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        """Zero the counters."""
        self.collectives = 0
        self.collective_s = 0.0
        self.calls: List[tuple] = []
        self.phase_s: Dict[str, float] = {}
        self.rounds: List[int] = []

    def as_dict(self) -> dict:
        return dict(collectives=self.collectives,
                    collective_s=self.collective_s, calls=list(self.calls),
                    phase_s=dict(self.phase_s), rounds=list(self.rounds))

    @contextlib.contextmanager
    def phase(self, name: str, device: torch.device):
        """Add the seconds of the block, device work included, to
        phase_s[name] (minus the collectives inside it)."""
        _sync(device)
        t0, c0 = time.perf_counter(), self.collective_s
        yield
        _sync(device)
        dt = time.perf_counter() - t0 - (self.collective_s - c0)
        self.phase_s[name] = self.phase_s.get(name, 0.0) + dt


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Axis:
    """One axis of a mesh as this rank sees it: its process group, its
    size, this rank's index on it, and the collectives over it."""

    def __init__(self, name: str, ranks: Sequence[int], group, stats: Stats):
        self.name = name
        self.ranks = list(ranks)
        self.group = group
        self.size = len(self.ranks)
        self.index = self.ranks.index(dist.get_rank())
        self.stats = stats

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """(size, *t.shape): every rank's t, stacked in axis order."""
        def run(x):
            out = [torch.empty_like(x) for _ in range(self.size)]
            dist.all_gather(out, x, group=self.group)
            return torch.stack(out)

        return self._collective("all_gather", t, run)

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of every rank's t."""
        def run(x):
            x = x.clone()
            dist.all_reduce(x, group=self.group)
            return x

        return self._collective("all_reduce", t, run)

    def reduce_scatter(self, t: torch.Tensor) -> torch.Tensor:
        """t: (size * k, ...). The sum over ranks of every rank's rows
        [index * k, (index + 1) * k)."""
        def run(x):
            out = x.new_empty((x.shape[0] // self.size, *x.shape[1:]))
            dist.reduce_scatter_tensor(out, x.contiguous(), group=self.group)
            return out

        return self._collective("reduce_scatter", t, run)

    def _collective(self, op: str, t: torch.Tensor, run) -> torch.Tensor:
        st = self.stats
        _sync(t.device)
        t0 = time.perf_counter()
        if self.size == 1:      # nothing to exchange
            out = t[None].clone() if op == "all_gather" else t.clone()
        else:
            out = run(t)
        _sync(t.device)
        dt = time.perf_counter() - t0
        st.collectives += 1
        st.collective_s += dt
        st.calls.append((op, t.numel() * t.element_size(), dt))
        return out


class Mesh:
    """A (data, seq) mesh of ranks as this rank sees it: `axis(name)` (or
    the attributes `data`, `seq`) for each axis, `world` for both, the
    rank's `device`, and the shared `stats`."""

    def __init__(self, data: Axis, seq: Axis, world: Axis,
                 device: torch.device, stats: Stats):
        self.data, self.seq, self.world = data, seq, world
        self.device = device
        self.stats = stats

    @property
    def shape(self) -> Dict[str, int]:
        return {DATA_AXIS: self.data.size, SEQ_AXIS: self.seq.size}

    def axis(self, name: str) -> Axis:
        return {DATA_AXIS: self.data, SEQ_AXIS: self.seq}[name]


def mesh_over(ranks: Sequence[int], data: int, seq: int,
              device="cuda") -> Optional[Mesh]:
    """The (data, seq) mesh over `ranks` of the initialized process group,
    seq innermost. Every rank of the group must call it (the first call
    for these arguments creates the sub-groups, later ones return the
    same mesh); a rank outside `ranks` gets None."""
    global _meshes_group
    if not dist.is_initialized():
        raise RuntimeError("a mesh needs an initialized torch.distributed "
                           "process group (dist.init_process_group)")
    ranks = tuple(ranks)
    if len(ranks) != data * seq or data < 1 or seq < 1:
        raise ValueError(f"a ({data}, {seq}) mesh needs {data * seq} ranks, "
                         f"got {len(ranks)}")
    dev = rank_device(device)
    if dist.group.WORLD is not _meshes_group:   # a new default group
        _meshes.clear()
        _meshes_group = dist.group.WORLD
    key = (ranks, data, seq, dev)
    if key not in _meshes:
        _meshes[key] = _new_mesh(list(ranks), data, seq, dev)
    return _meshes[key]


def _new_mesh(ranks: List[int], data: int, seq: int,
              dev: torch.device) -> Optional[Mesh]:
    stats = Stats()
    me = dist.get_rank()
    world_group = dist.new_group(ranks)
    seq_rows = [ranks[d * seq:(d + 1) * seq] for d in range(data)]
    data_cols = [ranks[j::seq] for j in range(seq)]
    seq_groups = [dist.new_group(r) for r in seq_rows]
    data_groups = [dist.new_group(r) for r in data_cols]
    if me not in ranks:
        return None
    d, j = divmod(ranks.index(me), seq)

    def axis(name, members: List[int], group):
        return Axis(name, members, group, stats)

    return Mesh(axis(DATA_AXIS, data_cols[j], data_groups[j]),
                axis(SEQ_AXIS, seq_rows[d], seq_groups[d]),
                axis("world", ranks, world_group), dev, stats)


def make_mesh(data: int = 1, seq: int = 1, device="cuda") -> Mesh:
    """The (data, seq) mesh over every rank of the initialized process
    group, whose world size must be data*seq; the same mesh on every call
    in one group. Raises without a process group: a mesh never falls back
    to one rank."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialized torch.distributed "
                           "process group (dist.init_process_group)")
    world = dist.get_world_size()
    if world != data * seq:
        raise ValueError(f"a ({data}, {seq}) mesh needs a process group of "
                         f"{data * seq} ranks, this one has {world}")
    return mesh_over(range(world), data, seq, device)
