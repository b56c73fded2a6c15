"""The port's benchmark: run one cell once and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell names a configuration and a traffic mix in ``BENCHMARK.json``;
everything else is found by name under ``portbench/`` (``harness/cells.py``).
Needs as many CUDA devices as the cell asks for; exits non-zero without
them, and prints no result.
"""
import os
import sys
import time

T_START = time.perf_counter()
HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
os.environ.setdefault("USE_FLAX", "0")

if __name__ == "__main__":
    sys.path[:0] = [HERE, ROOT]
    from harness import runner

    sys.exit(runner.main(sys.argv[1:], T_START))
