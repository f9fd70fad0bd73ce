"""Port parity of the MoE decoder's train step: the granite-moe-1b-a400m
smoke model (cut to 1 layer: the reference's td_vmm runs in interpret
mode inside its jitted step, which compiles slowly; d 64, 8 experts
top-2) at its config's remat "dots", forward with keys, the expert
lanes' STE backward, the router losses, 2 microbatches of the global
batch 4 x 16 and AdamW, two steps from the reference's converted init,
float32 compute, the reference under `jax.jit` (its remat "dots" is
``checkpoint_dots_with_no_batch_dims``).  Here td (the solved
exact-regime policy, noise on); quant (2 layers) is
`tests/test_torch_moe_train_quant.py`.  Tolerances as
`tests/test_torch_train_step.py` (`torch_train_parity.check_float32_steps`).
"""
import torch_threads  # noqa: F401  (first: torch's threads under xdist)
from torch_train_parity import archs, check_float32_steps


def test_td_train_steps_match_reference(monkeypatch):
    ja, ta = archs("granite-moe-1b-a400m", "td", "float32", remat="dots",
                   n_layers=1)
    check_float32_steps(ja, ta, monkeypatch)
