"""Runs one cell of the benchmark of ``cp_pfdr_graph_d1_tpu_torch`` once.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout, on a machine with an NVIDIA GPU.  Prints the
numbers compared against the plain reference as the last lines of standard
error, and one JSON object as the last line of standard output: with
``--trace 0`` the cell's end-to-end metrics, with ``--trace 1`` its
per-layer metrics, a fixed slice of the window profiled.  Exits non-zero,
printing no result, without a CUDA device (it never falls back to the CPU)
or if JAX or the JAX package was loaded.  ``benchmark/README.md`` says how
cells, mixes and metrics are added.
"""
import time

T_START_NS = time.perf_counter_ns()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

# one process, one host thread: the port's host work is single-threaded,
# and idle BLAS or OpenMP workers spinning beside it slow it unevenly on a
# shared host
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[_var] = "1"

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    sys.path.insert(1, str(ROOT))   # the port, beside benchmark/
    import torch

    from harness import cell, spec

    bench = spec.load_benchmark(ROOT)
    entry = {w["name"]: w for w in bench["workloads"]}.get(args.workload)
    if entry is None:
        print(f"run.py: no workload {args.workload!r} in BENCHMARK.json",
              file=sys.stderr)
        return 2
    if (not torch.cuda.is_available()
            or torch.cuda.device_count() < int(entry["chips"])):
        print(f"run.py: cell {args.workload} needs {entry['chips']} CUDA "
              f"device(s); torch.cuda.is_available() is "
              f"{torch.cuda.is_available()}, device_count "
              f"{torch.cuda.device_count()}", file=sys.stderr)
        return 3
    torch.set_num_threads(1)
    result, lines, _ = cell.run(args.workload, args.seed, args.seconds,
                             bool(args.trace), t_start_ns=T_START_NS,
                             device="cuda")
    found = cell.modules_found()
    if found:
        print(f"run.py: the run loaded {found}; the benchmark may load "
              f"neither JAX nor the JAX package", file=sys.stderr)
        return 4
    cell.emit(result, lines)
    return 0


if __name__ == "__main__":
    sys.exit(main())
