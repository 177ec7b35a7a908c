"""Run one cell of the port's benchmark once and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout that holds the port.  The cells, their
configurations, traffic mixes and metrics are named in ``BENCHMARK.json``;
``harness.py`` says what a run does.  It needs as many CUDA devices as
the cell asks for, and exits 2 without a result where there are fewer.
"""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

# libraries that would load JAX by themselves are kept from it
os.environ.setdefault("USE_FLAX", "0")
os.environ.setdefault("USE_TF", "0")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from portbench import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:], T_START))
