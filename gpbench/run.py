#!/usr/bin/env python3
"""Benchmark of gpgradpy_torch on NVIDIA GPUs: one cell of BENCHMARK.json
per process.

    python3 gpbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Prints one JSON line (correct, attempted, failed, metrics, device, and
with --trace 1 breakdown; the numbers compared with their limits last).
Exits non-zero with no result where no card is found.  See
gpbench/harness.py.
"""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from gpbench import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:], T_START))
