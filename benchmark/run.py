"""Run one cell of the benchmark of rocjpeg_tpu_torch once.

    python3 benchmark/run.py --workload <config>.<mix> --seed <n> \\
        --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the cell's CUDA cards.
Prints the run's result as one JSON line, last on standard output; each
number the correctness check compares, with its limit, goes last on
standard error. Without the cards, or with a module of JAX or of the JAX
package loaded, it prints no result and exits with another code than 0.
"""

import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]

if __name__ == "__main__":
    from harness import runner
    sys.exit(runner.main())
