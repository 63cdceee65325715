#!/usr/bin/env python3
"""The benchmark of the PyTorch/CUDA port (moonrtx_tpu_torch), one run:

    python3 portbench/run.py --workload march.jump --seed 7 --seconds 30 \\
        --trace 0

from the root of a checkout with a CUDA card. The cells, configurations
and metrics are in BENCHMARK.json; see portbench/harness/.
"""

import sys
import time

T_START = time.perf_counter()

if __name__ == "__main__":
    from harness.cli import main

    sys.exit(main(t_start=T_START))
