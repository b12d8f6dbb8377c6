"""Run one benchmark cell once on the card and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. Exits non-zero, printing no result, without a
CUDA device or with fewer than the cell's cards, and if any module of JAX or
of the JAX package ``pprx`` is loaded when the window has closed.
"""

import time

T_START = time.perf_counter()  # set-up counts from here: imports, inputs, warm-up

import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from benchmark import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:], T_START))
