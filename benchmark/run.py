"""Run one cell of the benchmark once, from the root of a checkout:

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Prints, as the last line of standard output, one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics with
``--trace 0``, its per-layer metrics with ``--trace 1``), ``device`` (and
with ``--trace 1`` ``breakdown``), and last ``checks``, each compared
number beside its limit; the same numbers close standard error.  Exits
non-zero and prints no result without enough CUDA devices, when a file of
the cell is missing or malformed, or when the run loaded JAX or the JAX
package.
"""

import time

T0 = time.monotonic()

import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from benchmark import core  # noqa: E402

if __name__ == "__main__":
    sys.exit(core.main(sys.argv[1:], t0=T0))
