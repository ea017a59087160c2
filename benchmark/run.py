"""Run one cell of the benchmark of qoi_tpu_torch once, on one CUDA card.

    python3 benchmark/run.py --workload capture4k-encode --seed 7 \\
        --seconds 10 --trace 0

Prints, on standard output, a line of notes (the hand-written kernels'
launches a request, the card's power limit, the program's counters) and
then, as its last line, the result: `correct`, `attempted`, `failed`,
`metrics` (the cell's end-to-end metrics with --trace 0, its per-layer
metrics with --trace 1), `device`, with --trace 1 `breakdown`, and last
`checks`, each compared number with its limit. The same numbers end
standard error. Exits 2 without a result when torch sees no CUDA card or
fewer than the cell asks for, or the program cannot be imported, and 3
when the process has loaded the JAX stack or the JAX package.
"""
import time

T_PROCESS = time.monotonic()  # set-up is counted from here

import argparse  # noqa: E402
import json  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent
# import the harness as the package `benchmark` from the repository root,
# never its files as top-level modules from the script's directory
sys.path[:] = [p for p in sys.path if pathlib.Path(p or ".").resolve() != HERE]
sys.path.insert(0, str(ROOT))


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    opts = parse(argv)
    import torch

    from benchmark import guard, harness

    torch.set_num_threads(2)
    bench = harness.load_benchmark(ROOT)
    cells = {w["name"]: w for w in bench["workloads"]}
    if opts.workload not in cells:
        harness.log(f"no workload {opts.workload!r}; have {sorted(cells)}")
        return 2
    chips = cells[opts.workload]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        harness.log(f"needs {chips} CUDA device(s); torch sees "
                    f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    try:
        import qoi_tpu_torch  # noqa: F401  (the program under test)
    except ImportError as e:
        harness.log(f"the program cannot be imported: {e}")
        return 2

    result, notes = harness.run_cell(
        opts.workload, opts.seed, opts.seconds, bool(opts.trace),
        device="cuda:0", root=ROOT, t_process=T_PROCESS)

    found = guard.loaded_forbidden()
    if found:
        harness.log("the run loaded forbidden modules: " + ", ".join(found))
        return 3
    print(json.dumps(notes), flush=True)
    for name, c in result["checks"].items():
        harness.log(f"check {name} {c['value']} limit {c['limit']}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
