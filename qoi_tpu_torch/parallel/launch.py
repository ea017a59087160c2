"""A local process group to run the sequence-parallel codec in: S ranks
on this machine, joined by gloo over 127.0.0.1.

    with RankPool(4) as pool:
        results = pool.run(fn, *args)     # fn(*args) on every rank

Each rank is a process started with the "spawn" method (a CUDA context
does not survive fork) that brings up the process group once and then
runs the functions it is sent, in order. `fn` must be importable by name
(a module-level function); every rank returns fn's value, or its
traceback, which `run` raises. On a machine with one card every rank
computes on cuda:0 (`sharding.rank_device`). Build the kernels in the
parent first (kernels/_build.build), or every rank runs nvcc.
"""
from __future__ import annotations

import datetime
import multiprocessing as mp
import os
import queue
import socket
import traceback
from typing import Any, Callable, List


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(rank: int, world: int, port: int, device: str,
               timeout_s: float, tasks, results) -> None:
    import torch
    import torch.distributed as dist

    dist.init_process_group(
        "gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=world,
        rank=rank, timeout=datetime.timedelta(seconds=timeout_s))
    if device == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    else:   # the ranks share the machine's cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    try:
        while True:
            task = tasks.get()
            if task is None:
                break
            fn, args = task
            try:
                results.put((rank, True, fn(*args)))
            except Exception:   # reported to the parent, which raises
                results.put((rank, False, traceback.format_exc()))
    finally:
        dist.destroy_process_group()


class RankPool:
    """`world` spawned ranks in one gloo process group. `device` ("cuda",
    the default, or "cpu") decides whether each rank selects its card or takes its share
    of the CPU's cores as torch threads;
    `timeout_s` bounds the group's collectives and each `run`."""

    def __init__(self, world: int, device: str = "cuda",
                 timeout_s: float = 300.0):
        self.world = world
        self.device = device
        self.timeout_s = timeout_s
        self._start()

    def _start(self) -> None:
        ctx = mp.get_context("spawn")
        self._tasks = [ctx.Queue() for _ in range(self.world)]
        self._results = ctx.Queue()
        port = _free_port()
        self._procs = [ctx.Process(
            target=_rank_main,
            args=(r, self.world, port, self.device, self.timeout_s,
                  self._tasks[r], self._results),
            daemon=True) for r in range(self.world)]
        for p in self._procs:
            p.start()

    def run(self, fn: Callable, *args: Any) -> List[Any]:
        """fn(*args) on every rank; the ranks' values in rank order.
        Raises if a rank raised, died, or did not answer in time; the
        ranks are then started anew, since the others may wait in a
        collective the failed one never joins."""
        for q in self._tasks:
            q.put((fn, args))
        out = [None] * self.world
        for _ in range(self.world):
            try:
                rank, ok, val = self._results.get(timeout=self.timeout_s)
            except queue.Empty:
                dead = [r for r, p in enumerate(self._procs)
                        if not p.is_alive()]
                self._restart()
                raise TimeoutError(
                    f"{fn.__name__}: no answer from every rank in "
                    f"{self.timeout_s} s (ranks not alive: {dead})") from None
            if not ok:
                self._restart()
                raise RuntimeError(f"{fn.__name__} failed on rank {rank}:\n"
                                   f"{val}")
            out[rank] = val
        return out

    def _restart(self) -> None:
        self._stop(kill=True)
        self._start()

    def _stop(self, kill: bool) -> None:
        if not kill:
            for q in self._tasks:
                q.put(None)
        for p in self._procs:
            p.join(timeout=0 if kill else 10)
            if p.is_alive():
                p.kill()
                p.join()

    def close(self) -> None:
        """Stop every rank: a clean exit where they are idle, else kill."""
        self._stop(kill=False)

    def __enter__(self) -> "RankPool":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
