"""Run one cell of the benchmark of soft_robot_control_tpu_torch once.

    python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout, on a machine with an NVIDIA card. It prints
the numbers of its correctness check as its last lines on standard error
and one JSON line as the last line of standard output; without a card it
exits with code 2 and prints no result.
"""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the checkout's root, in place of this folder, heads the import path
if sys.path and os.path.abspath(sys.path[0]) == os.path.join(ROOT,
                                                             "port_bench"):
    sys.path[0] = ROOT
else:
    sys.path.insert(0, ROOT)

from port_bench.harness.cli import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(t_start=T_START))
