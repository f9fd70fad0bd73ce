"""The benchmark's CPU tests: the repository root and ``src`` on the
path, torch on a share of the cores, the TD policy solved on the CPU.  Tests
that need the card carry the ``chip`` marker and skip here; the decision
is made inside a fixture (`chip`), never at import."""
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
for p in (ROOT, os.path.join(ROOT, "src")):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "chip: needs a CUDA card (run on the chip: python3 -m "
        "pytest -m chip tdbench/tests)")


@pytest.fixture(scope="session", autouse=True)
def cpu_session():
    import torch
    # a share of the cores a worker, so that parallel workers' smoke
    # windows each see about as many engine steps as a run alone
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    torch.set_num_threads(max(1, min(4, (os.cpu_count() or 1) // workers)))
    from repro_torch.core import explorer
    prev = explorer.set_service(explorer.ExplorerService(device="cpu"))
    yield
    explorer.set_service(prev)


@pytest.fixture
def chip():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)
