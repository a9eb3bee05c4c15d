"""Run one cell of the port's benchmark on the CUDA device of this
machine and print its result as the last line of standard output.

    python3 portbench/run.py --workload btc_er2m.q1024 --seed 7 \
        --seconds 30 --trace 0

Run it from the root of a checkout: the kernel library is built (once)
and cached under the checkout's ``build/``. Exits nonzero, printing no
result, without a CUDA device, outside a checkout that holds
``src/repro_torch``, if the run loaded JAX or the JAX package, or if a
metric the cell lists had nothing to read.
"""
import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# the checkout's root and its src/, never this directory, so no module
# here shadows one of the standard library
sys.path[0:1] = [str(ROOT), str(ROOT / "src")]
# every cache of the run inside the checkout, at fixed paths
for var, sub in (("TRITON_CACHE_DIR", "triton"),
                 ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("CUDA_CACHE_PATH", "cuda_cache")):
    os.environ[var] = str(ROOT / "build" / sub)

from portbench.bench import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], T_START))
