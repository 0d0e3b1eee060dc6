"""Run one cell of the benchmark once, from the root of a checkout::

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

Prints the cell's result as the last line of standard output (see
``benchmark/harness.py``). Exits 3 without a result when the machine has
fewer CUDA devices than the cell asks for, and 2 when the program is not in
the checkout.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="benchmark/run.py",
                                description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    # the run's kernel builds live in the checkout (build/kernels/, where
    # the program puts them); nothing here may load JAX
    os.environ.setdefault("USE_FLAX", "0")
    from benchmark.harness import resolve, run_cell

    # a host-bound mix runs its host with few threads, set before numpy and
    # torch start their thread pools: the host's time then spreads less
    threads = resolve(args.workload)[2].get("host_threads")
    if threads:
        for var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS",
                    "MKL_NUM_THREADS"):
            os.environ[var] = str(threads)

    rc, _ = run_cell(args.workload, args.seed, args.seconds,
                     bool(args.trace), t_start=T_START)
    return rc


if __name__ == "__main__":
    sys.exit(main())
