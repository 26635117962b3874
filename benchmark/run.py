"""Run one cell of the benchmark of x3d_tpu_torch and print its result.

    python3 benchmark/run.py --workload W --seed N --seconds S --trace 0|1

from the root of a checkout (``benchmark/harness.py`` says what a run
does).  The last line of standard output is the result, a JSON object.
"""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
os.environ.setdefault("USE_FLAX", "0")

if __name__ == "__main__":
    from benchmark import harness

    sys.exit(harness.main(sys.argv[1:], T_START))
