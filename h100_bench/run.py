"""Run one cell of the H100 benchmark once.

    python3 h100_bench/run.py --workload claro.train --seed 7 --seconds 30 --trace 0

Reads ``BENCHMARK.json`` at the checkout's root, builds the cell's
configuration under its traffic mix on the card, measures for
``--seconds`` seconds (``--trace 1``: a traced window instead, for the
per-layer metrics), checks what the timed path produced against the
plain references of ``h100_bench/reference``, and prints one JSON line
last on standard output.  Exits non-zero, with no result, when the card
or the program is missing.
"""

import os
import sys
import time

T0 = time.monotonic()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# Kernel caches at fixed paths inside the checkout, so a cell's second
# run finds every kernel built (the program's own nvcc cache is
# ``build/gantrack_tpu_torch``).
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(ROOT, "build", "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, "build", "triton")
# The checkout's root, not this folder, heads the path: the harness is
# the package ``h100_bench``.
sys.path[0] = ROOT

if __name__ == "__main__":
    from h100_bench import core

    sys.exit(core.main(sys.argv[1:], T0))
