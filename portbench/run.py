"""The benchmark's command: one run of one cell on the card (see README.md).

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>
"""

import time

T_START = time.perf_counter()  # set-up is counted from here

import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from portbench import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:], T_START))
