"""Run one cell of the benchmark: ``python3 treantbench/run.py --workload
<cell> --seed <n> --seconds <s> --trace <0|1>`` from the checkout's root.
Prints one JSON line (the last of standard output); needs a CUDA card."""

import time

T_START = time.perf_counter()

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

if __name__ == "__main__":
    from treantbench.harness.cli import main

    sys.exit(main(sys.argv[1:], T_START))
