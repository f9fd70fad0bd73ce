"""Run one cell of the port's benchmark once and print its result line.

    python3 tdbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout of the repository, on a machine with the
cell's CUDA devices.  The last line of standard output is the result (a
JSON object); the numbers the output check compared, each beside its
limit, are the last lines of standard error.  Kernel libraries build
into ``build/kernels`` of the checkout at a cell's first run there, and
every cache stays in ``build/`` of the checkout.
"""
import time

T0 = time.monotonic()

import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[0] = ROOT
sys.path.insert(1, os.path.join(ROOT, "src"))
CACHE = os.path.join(ROOT, "build", "tdbench")
os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
os.environ["TORCHINDUCTOR_CACHE_DIR"] = os.path.join(CACHE, "inductor")
os.environ["USE_FLAX"] = "0"

from tdbench import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:], T0))
