"""The port's benchmark, one cell a run (``BENCHMARK.json``).

    python3 gbdt_bench/run.py --workload higgs-train --seed 7 --seconds 30 --trace 0

Run from the root of a checkout.  The port's kernels build into the
checkout's ``build/`` (the port's own fixed place); any Triton or torch
extension cache goes under it too.
"""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
os.environ["USE_FLAX"] = "0"
os.environ["USE_JAX"] = "0"
# the checkout's root on the path, and not this folder (its subfolders'
# names would shadow other packages)
sys.path[:] = [str(ROOT)] + [p for p in sys.path
                             if Path(p or ".").resolve() != ROOT / "gbdt_bench"]

from gbdt_bench.harness.cli import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], T_START))
