"""Port parity of the MoE decoder's train step in quant mode: the
granite-moe-1b-a400m smoke model (2 layers) at its config's remat "dots",
as `tests/test_torch_moe_train.py` runs td mode (the same harness and
tolerances)."""
import torch_threads  # noqa: F401  (first: torch's threads under xdist)
from torch_train_parity import archs, check_float32_steps


def test_quant_train_steps_match_reference(monkeypatch):
    ja, ta = archs("granite-moe-1b-a400m", "quant", "float32", remat="dots")
    check_float32_steps(ja, ta, monkeypatch)
