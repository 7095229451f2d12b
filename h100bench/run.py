"""Run one cell of the benchmark of the port (``repro_torch``) on the card.

    python3 h100bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Prints progress lines, then the checks on standard error, then one JSON
result line.  See ``h100bench/README.md``.
"""

import time

T_PROCESS = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# Caches stay inside the checkout, at fixed paths; the kernels' libraries
# are built into build/kernels/ by the program itself.
os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(ROOT / "build" / "torch_extensions"))
os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))
os.environ.setdefault("USE_FLAX", "0")
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

from h100bench.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(t_process=T_PROCESS))
