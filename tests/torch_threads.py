"""Caps torch's intra-op threads in a pytest-xdist worker.  Every
`tests/test_torch_*.py` imports this module first.

Each xdist worker would otherwise start torch's full intra-op pool, one
thread a core, and N workers on the same cores would run N times as many
threads as there are cores.  Under xdist (``PYTEST_XDIST_WORKER_COUNT``
set) each worker takes its share of the cores, at least one; a run in one
process keeps torch's default.  Not a test module itself."""
import os

import torch

_workers = os.environ.get("PYTEST_XDIST_WORKER_COUNT")
if _workers:
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // int(_workers)))
