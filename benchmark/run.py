"""Run one cell of the benchmark once and print its result line.

    python3 -m benchmark.run --workload <cell> --seed <n> \
        --seconds <s> --trace <0|1>

from the root of a checkout. The last line of standard output is the
result as one JSON object; the numbers `correct` was judged by, each
beside its limit, are the last lines of standard error. Without a CUDA
device, or with fewer than the cell asks for, it prints no result and
exits with 2.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402


def parse(argv: list[str]) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="python3 -m benchmark.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    # a run with the timed path broken on purpose (benchmark/faults.py):
    # its result must come out not correct
    ap.add_argument("--fault", default="none")
    return ap.parse_args(argv)


def main(argv: list[str] | None = None) -> int:
    args = parse(sys.argv[1:] if argv is None else argv)
    from . import harness
    root = os.getcwd()
    return harness.main(root, args.workload, args.seed, args.seconds,
                        bool(args.trace), args.fault, T_START)


if __name__ == "__main__":
    sys.exit(main())
