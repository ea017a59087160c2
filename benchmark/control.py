"""The control of a cell's correctness check, and the program's readings
beside it, on the same inputs.

    python3 benchmark/control.py --workload capture4k-decode \\
        --seed 11 --seed 12 --seed 13

For each seed it makes the cell's inputs as a run does, then reads the
check's numbers twice over the same answers (the pool's items in the
run's order, as many as a run checks): once for the program (one request
each) and once for the control, the reference at 7 bits a channel put in
the program's place. The control has to come out not correct. Prints one
JSON line a seed. The benchmark's own runs never run this.
"""
import argparse
import json
import pathlib
import sys
import time

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent
sys.path[:] = [p for p in sys.path if pathlib.Path(p or ".").resolve() != HERE]
sys.path.insert(0, str(ROOT))


def readings(workload: str, seed: int, device="cuda", *,
             root: pathlib.Path = ROOT, overrides=None) -> dict:
    """{"program": checks, "control": checks} for one seed, each check
    {name: (value, limit)}, plus whether each is correct."""
    import torch

    from benchmark import harness

    dev = torch.device(device)
    cell = harness.load_cell(workload, root)
    cfg = dict(cell.config, **(overrides or {}))
    state, order = harness.make_inputs(cell, cfg, seed, dev)
    n = harness.SAMPLE
    items = [order[i % len(order)] for i in range(n)]
    out = {}
    for side in ("program", "control"):
        t0 = time.perf_counter()
        answers = {}
        counters = {}
        failed = 0
        for k in sorted(set(items)):
            if side == "program":
                res = cell.entry.request(state, k)
                failed += not res.ok
                answers[k] = res.output
                for name, v in res.counters.items():
                    counters.setdefault(name, []).append(v)
            else:
                answers[k] = cell.entry.control_output(state, k)
        checks = {"failed": (failed, 0)}
        checks.update(cell.entry.check(state, [(k, answers[k])
                                               for k in items]))
        del answers
        out[side] = {"checks": checks,
                     "correct": all(v <= lim for v, lim in checks.values()),
                     "counters": counters,
                     "seconds": time.perf_counter() - t0}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, action="append", required=True)
    opts = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    for seed in opts.seed:
        r = readings(opts.workload, seed, "cuda:0")
        print(json.dumps({"workload": opts.workload, "seed": seed, **r,
                          "device": torch.cuda.get_device_name(0)}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
