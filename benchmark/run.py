"""Run one cell of the benchmark once and print its result as one JSON line.

    python3 benchmark/run.py --workload NAME --seed N --seconds S --trace 0|1

Run from the root of a checkout on a machine with the CUDA cards the cell
asks for (``BENCHMARK.json``). The last line of standard output is the
result; the numbers that decided ``correct`` follow on standard error.
"""

import time

T0 = time.perf_counter()  # the start of the process, for setup_s

import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from benchmark import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:], T0))
