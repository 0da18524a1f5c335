#!/usr/bin/env python3
"""One run of one cell of the port's benchmark, from the checkout's root:

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Prints the card's name and power limit, a few lines on the run, and last
one JSON line: correct, attempted, failed, metrics (the cell's end-to-end
metrics, or with --trace 1 its per-layer ones), device, breakdown (traced)
and compared (each number the reference compared, with its limit; also
the last lines on standard error).  Exits 2 without a result where no
CUDA device is found, where the cell needs more devices than there are,
and where the run loaded JAX or the JAX package.  See harness.py.
"""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

if __name__ == "__main__":
    # the checkout's root, not this folder, leads the import path
    ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path[0] = ROOT
    # any import of JAX or of the JAX package now fails
    for _name in ("jax", "jaxlib", "flax", "aom_av1_lavish_tpu"):
        sys.modules[_name] = None
    from benchmark.harness import main
    sys.exit(main(t_start=T_START))
