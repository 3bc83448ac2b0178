#!/usr/bin/env python3
"""Run one cell of the benchmark of ssdseglib_torch (see benchmark/README.md):

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The last line of standard output is the
result's JSON object; the numbers compared with their limits are the last
lines of standard error."""

import os
import sys
import time

STARTED = time.perf_counter()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(ROOT, "benchmark", ".cache")
# every build and kernel cache at a fixed path inside the checkout (the
# program's own nvcc library builds into ssdseglib_torch/build/)
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE, "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
os.environ["CUDA_CACHE_PATH"] = os.path.join(CACHE, "nv_compute")
os.environ.setdefault("USE_FLAX", "0")
sys.path.insert(0, ROOT)

from benchmark.harness.cli import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], STARTED))
