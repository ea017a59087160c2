"""The benchmark's harness: cells found by name, one run of a cell.

Everything that belongs to one configuration, traffic mix, entry or
metric is a file of its own, found by the name `BENCHMARK.json` gives:

- `BENCHMARK.json`'s `configs[].file`: the configuration (frame size,
  content and its palette classes, the guarantees);
- `benchmark/traffic/<traffic>.json`: the mix: `entry`, the entry module
  its requests drive, and `pool`, the number of frames they cycle over;
- `benchmark/entries/<entry>.py`: the code that drives one entry point
  of the program (see `benchmark/entry.py`);
- `benchmark/metrics/<metric>.py`: a reader with `read(ctx)`, returning a
  number or None (nothing to read: the metric is left out), and
  `SPANS`, the program functions it needs wrapped in the traced run.

A run: the pool's frames made on the device from the seed, the entry's
inputs, one warm-up request on every pool item (all of that is set-up),
then the window, then the comparison of a seeded sample of `SAMPLE` of
the window's answers. The window is the one traffic shape the harness
has: a closed loop of one client with one request in flight, cycling
over the pool in an order drawn from the seed, for `seconds`. With
trace=1 the loop runs with the layer spans installed and torch.profiler
records a stretch of `TRACED_REQUESTS` requests in it.
"""
from __future__ import annotations

import importlib.util
import json
import pathlib
import random
import statistics
import subprocess
import sys
import time
from dataclasses import dataclass, field
from types import ModuleType
from typing import Dict, List, Optional, Tuple

import torch

from benchmark import frames as framegen
from benchmark import tracing

ROOT = pathlib.Path(__file__).resolve().parents[1]
BENCH = "benchmark"
HBM_BYTES_PER_S = 3.35e12  # one H100 SXM, NVIDIA's data sheet, 700 W
SAMPLE = 32           # window answers compared with the reference a run
TRACED_REQUESTS = 16  # requests in the traced stretch
TRAFFIC_KEYS = {"entry", "pool"}


def _load_module(path: pathlib.Path, name: str) -> ModuleType:
    if not path.is_file():
        raise FileNotFoundError(f"no file {path}")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclass
class Metric:
    spec: dict
    reader: ModuleType

    @property
    def name(self) -> str:
        return self.spec["name"]


@dataclass
class Cell:
    name: str
    spec: dict
    config: dict
    traffic: dict
    entry: ModuleType
    end_to_end: List[Metric]
    per_layer: List[Metric]


def load_benchmark(root: pathlib.Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_metric(root: pathlib.Path, spec: dict) -> Metric:
    name = spec["name"]
    path = root / BENCH / "metrics" / f"{name}.py"
    return Metric(spec, _load_module(path, f"benchmark_metric_{name}"))


def load_cell(workload: str, root: pathlib.Path = ROOT) -> Cell:
    bench = load_benchmark(root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r}; have {sorted(cells)}")
    w = cells[workload]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    with open(root / conf["file"]) as f:
        config = json.load(f)
    with open(root / BENCH / "traffic" / f"{w['traffic']}.json") as f:
        traffic = json.load(f)
    if set(traffic) != TRAFFIC_KEYS:
        raise ValueError(f"traffic {w['traffic']!r} has the keys "
                         f"{sorted(traffic)}; a mix is {sorted(TRAFFIC_KEYS)}")
    entry = _load_module(root / BENCH / "entries" / f"{traffic['entry']}.py",
                         f"benchmark_entry_{traffic['entry']}")
    e2e = [load_metric(root, m) for m in bench["end_to_end"]
           if _applies(m, workload)]
    layer = [load_metric(root, m) for m in bench["per_layer"]
             if _applies(m, workload)]
    return Cell(workload, w, config, traffic, entry, e2e, layer)


@dataclass
class Window:
    latencies_s: List[float] = field(default_factory=list)
    pixels: int = 0
    seconds: float = 0.0
    attempted: int = 0
    failed: int = 0
    counters: Dict[str, List[int]] = field(default_factory=dict)
    items: List[int] = field(default_factory=list)  # pool item a request
    stretch_requests: int = 0  # requests in the traced stretch, and
    stretch_s: float = 0.0     # its host time, the profiler's own included


def _latency_summary(lat: List[float], items: List[int]) -> dict:
    """Median, 95th percentile and largest latency in ms, and the mean
    of each pool item (a diagnostic line, not a metric)."""
    if len(lat) < 2:
        return {}
    by: Dict[int, List[float]] = {}
    for t, k in zip(lat, items):
        by.setdefault(k, []).append(t)
    return {"p50": statistics.median(lat) * 1e3,
            "p95": statistics.quantiles(lat, n=20, method="inclusive")[18]
            * 1e3,
            "max": max(lat) * 1e3,
            "item_mean": {k: statistics.fmean(v) * 1e3
                          for k, v in sorted(by.items())}}


@dataclass
class Context:
    """What a metric reader reads."""
    cell: Cell
    setup_s: float
    window: Window
    trace: Optional[tracing.TraceView] = None
    stretch_bytes: int = 0


def untraced_idle_pct(ctx: Context) -> Optional[float]:
    """The device's idle share of the window's untraced requests, in %:
    each request's device time as the traced stretch measured it (which
    the profiler does not slow) against the host time of the requests
    outside the stretch (which it does not slow either). None without a
    trace, device ops, or requests outside the stretch."""
    t, w = ctx.trace, ctx.window
    n = w.attempted - w.stretch_requests
    rest_s = w.seconds - w.stretch_s
    if t is None or t.frames <= 0 or t.busy_s <= 0 or n <= 0 or rest_s <= 0:
        return None
    return (1.0 - t.busy_s / t.frames * n / rest_s) * 100


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def power_limit_w() -> Optional[float]:
    """The card's power limit as nvidia-smi reads it, or None."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"],
            capture_output=True, text=True, timeout=30, check=True).stdout
        return float(out.strip().splitlines()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def _request(cell: Cell, state, k: int, what: str):
    """One request's Result, or None where it failed: it raised, or the
    program reported a failure."""
    try:
        res = cell.entry.request(state, k)
    except Exception as e:  # a request that raises is a failure
        log(f"{what} (pool item {k}) raised: {e!r}")
        return None
    return res if res.ok else None


def _profiler(dev: torch.device):
    acts = [torch.profiler.ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=acts)


def make_inputs(cell: Cell, cfg: dict, seed: int, dev: torch.device):
    """The pool's frames, the entry's state and the seeded request order."""
    kind = (cfg.get("content"), cfg.get("channels"))
    if kind != ("mixed", 4):
        raise ValueError(f"config {cfg.get('name')!r}: frames.py makes "
                         f"4-channel mixed content, not {kind}")
    pool = cell.traffic["pool"]
    classes = cfg["palette_classes"]
    if pool % len(classes):
        raise ValueError(f"a pool of {pool} frames does not hold the "
                         f"{len(classes)} palette classes in their shares")
    pxs = [framegen.frame(cfg["width"], cfg["height"],
                          framegen.frame_seed(seed, k), cfg["alpha"], dev,
                          classes[k % len(classes)])
           for k in range(pool)]
    state = cell.entry.prepare(cfg, pxs, dev)
    order = random.Random(seed).sample(range(pool), pool)
    return state, order


def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             device="cuda", *, root: pathlib.Path = ROOT,
             overrides: Optional[dict] = None,
             t_process: Optional[float] = None) -> Tuple[dict, dict]:
    """One run of a cell. Returns (result, notes): the result line's
    object and the notes printed on an earlier line (launches of the
    hand-written kernels a request, the card's power limit, streams)."""
    t_start = time.monotonic() if t_process is None else t_process
    dev = torch.device(device)
    cell = load_cell(workload, root)
    cfg = dict(cell.config, **(overrides or {}))
    from qoi_tpu_torch.kernels import _build  # the program's launch counts

    t_inputs = time.monotonic()
    state, order = make_inputs(cell, cfg, seed, dev)
    _sync(dev)
    t_warm = time.monotonic()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    warm_failed = 0
    for k in order:  # every shape the window uses
        if _request(cell, state, k, "warm-up") is None:
            warm_failed += 1
    if trace:
        # the profiler's first start initialises its device tracing, which
        # takes seconds: do it here, not inside the window
        with _profiler(dev):
            _request(cell, state, order[0], "profiler warm-up")
    _sync(dev)
    _build.reset_launches()
    setup_s = time.monotonic() - t_start
    phases = {"imports": t_inputs - t_start, "inputs": t_warm - t_inputs,
              "warm_up": setup_s - (t_warm - t_start)}

    # ---- the window ----------------------------------------------------
    win = Window()
    sample_rng = random.Random(f"{seed}:sample")
    samples: List[Tuple[int, object]] = []
    n_traced = TRACED_REQUESTS if trace else 0
    targets = sorted({t for m in cell.per_layer
                      for t in getattr(m.reader, "SPANS", ())}) if trace else []
    prof = None
    traced_left = -1
    stretch_bytes = 0
    stretch = None
    with tracing.layer_spans(targets) as installed:
        t_win = time.perf_counter()
        i = seen = 0
        # the traced stretch, once begun, runs to its end
        while time.perf_counter() - t_win < seconds or traced_left > 0:
            if trace and traced_left < 0 and \
                    time.perf_counter() - t_win >= seconds / 4:
                t_stretch = time.perf_counter()
                prof = _profiler(dev)
                prof.start()
                stretch = torch.profiler.record_function(tracing.STRETCH)
                stretch.__enter__()
                traced_left = n_traced
            k = order[i % len(order)]
            t0 = time.perf_counter()
            res = _request(cell, state, k, f"request {i}")
            win.latencies_s.append(time.perf_counter() - t0)
            win.items.append(k)
            win.attempted += 1
            if res is None:
                win.failed += 1
            else:
                win.pixels += cfg["width"] * cfg["height"]
                for name, v in res.counters.items():
                    win.counters.setdefault(name, []).append(v)
                # a seeded uniform sample of the answers (reservoir)
                if len(samples) < SAMPLE:
                    samples.append((k, res.output))
                else:
                    j = sample_rng.randrange(seen + 1)
                    if j < SAMPLE:
                        samples[j] = (k, res.output)
                seen += 1
                if traced_left > 0:
                    stretch_bytes += res.bytes_moved
            if traced_left > 0:
                traced_left -= 1
                if traced_left == 0:
                    _sync(dev)
                    stretch.__exit__(None, None, None)
                    prof.stop()
                    win.stretch_s = time.perf_counter() - t_stretch
                    win.stretch_requests = n_traced
            del res
            i += 1
        _sync(dev)
        win.seconds = time.perf_counter() - t_win
    memory_peak = (torch.cuda.max_memory_allocated(dev)
                   if dev.type == "cuda" else 0)
    launches = {k: v / max(win.attempted, 1)
                for k, v in _build.launches.items() if v}

    view = None
    if prof is not None:
        view = tracing.TraceView(tracing.export_events(prof), installed,
                                 frames=n_traced)
        del prof

    # ---- correctness, after the window ----------------------------------
    checks = {"failed": (win.failed + warm_failed, 0)}
    checks.update(cell.entry.check(state, samples))
    correct = bool(samples) and all(v <= lim for v, lim in checks.values())
    n_checked = len(samples)
    del samples, state

    ctx = Context(cell, setup_s, win, view, stretch_bytes)
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        v = m.reader.read(ctx)
        if v is not None:
            metrics[m.name] = {"value": v, "unit": m.spec["unit"]}

    dev_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                "kind": (torch.cuda.get_device_name(dev)
                         if dev.type == "cuda" else "cpu"),
                "count": 1, "memory_peak_bytes": memory_peak}
    result = {"correct": correct, "attempted": win.attempted,
              "failed": win.failed, "metrics": metrics, "device": dev_info}
    if view is not None:
        dev_info["busy_s"] = view.busy_s
        dev_info["window_s"] = view.window_s
        result["breakdown"] = {"device_ops": view.device_ops(),
                               "idle_gaps": view.idle_gaps()}
    result["checks"] = {k: {"value": v, "limit": lim}
                        for k, (v, lim) in checks.items()}
    notes = {"workload": workload, "seed": seed,
             "launches_per_request": launches,
             "power_limit_w": power_limit_w() if dev.type == "cuda" else None,
             "answers_checked": n_checked,
             "setup_phases_s": phases,
             "latency_ms": _latency_summary(win.latencies_s, win.items),
             "counters_mean": {k: statistics.fmean(v)
                               for k, v in win.counters.items() if v}}
    if trace:
        notes["traced_requests"] = n_traced
        notes["spans_installed"] = sorted(installed)
    return result, notes
