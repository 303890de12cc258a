"""Readings that the limits of ``correct`` are set from (chip only; the
benchmark's own runs never run this).

    python3 benchmark/control.py --workload <cell> --seeds 1 2 ... \
        [--control-seeds 1 2 3] [--seconds s]

Each seed is one run of the cell through ``harness.cell.run``, all in this
process, at the cell's own size and load for ``--seconds`` (the
benchmark's ``run_seconds`` by default): the window, the sample of solves
checked and the verdict are those of ``run.py``.  ``--seeds`` run the
program as it is: the lower readings.  ``--control-seeds`` run the control
that ``check.control`` in the configuration names, in the program's place:

* ``"program:tf32"``: the program with TF32 matrix products switched on
  (the port turns them off when it is imported);
* ``"reference:<dtype>"`` (a torch dtype): the reference's own solves,
  computed in that precision.

One JSON line a run on standard output: the kind of run, the seed,
``correct``, and each number compared beside its limit.
"""
import time

T_START_NS = time.perf_counter_ns()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--seconds", type=float, default=None)
    args = ap.parse_args(argv)
    sys.path.insert(1, str(ROOT))
    import torch

    from harness import cell, spec

    if not torch.cuda.is_available():
        print("control.py: needs a CUDA device", file=sys.stderr)
        return 3
    seconds = args.seconds or spec.load_benchmark(ROOT)["run_seconds"]
    runs = [(False, s) for s in args.seeds] + \
        [(True, s) for s in args.control_seeds]
    for control, seed in runs:
        t0 = time.perf_counter_ns() if (control, seed) != runs[0] \
            else T_START_NS
        result, lines, _ = cell.run(args.workload, seed, seconds, False,
                                    t_start_ns=t0, device="cuda",
                                    control=control)
        for ln in lines:
            print(ln, file=sys.stderr)
        print(json.dumps(dict(
            kind="control" if control else "program", workload=args.workload,
            seed=seed, correct=result["correct"],
            solves=result["attempted"], checked=result["solves_checked"],
            checks=result["checks"])), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
