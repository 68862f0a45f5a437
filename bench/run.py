"""Run one cell of the benchmark once and print its result line.

    python bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds ``BENCHMARK.json``, this folder
and the port under ``src``. It needs as many CUDA cards as the cell asks
for, and exits non-zero without a result where there are fewer.
"""
import time

T_START = time.perf_counter()

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

# the checkout's root in place of this folder, whose subfolders'
# names must not shadow a library's modules
sys.path[0] = str(Path(__file__).resolve().parents[1])

from bench.harness.main import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(t_proc=T_START))
