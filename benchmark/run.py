"""One run of one benchmark cell on the card:

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  It prints the result as one JSON line, last
on standard output, and each number the correctness check compared beside
its limit, last on standard error.  See benchmark/harness.py."""

import os
import sys

if __name__ == "__main__":
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path[0] = root  # the checkout's root, not this directory
    from benchmark.harness import main

    sys.exit(main())
