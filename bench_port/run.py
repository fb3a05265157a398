"""Run one cell of the port's benchmark on the card:

    python bench_port/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The last line of standard output is the
result's JSON object; the numbers that decide `correct` are the last lines
of standard error. A run that finds fewer CUDA devices than the cell asks
for exits with an error and prints no result.
"""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# every cache the program or its libraries keep lives in the checkout
CACHE = os.path.join(ROOT, ".bench_cache")
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton"),
                 ("CUDA_CACHE_PATH", "cuda")):
    os.environ[var] = os.path.join(CACHE, sub)
os.environ.setdefault("USE_FLAX", "0")
sys.path.insert(0, ROOT)

if __name__ == "__main__":
    from bench_port.lib.harness import main

    sys.exit(main(sys.argv[1:]))
