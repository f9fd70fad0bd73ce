"""Port parity of the train step in bfloat16 compute (the configs'
default): the qwen3-8b smoke model, "td" (solved policy, noise on) and
"quant", 2 microbatches, remat "full", two steps.

The reference runs op by op (`jax.disable_jit`): XLA's CPU jit drops bf16
roundings (ROADMAP §3), while the port rounds after every op as the JAX
program reads.  Under `disable_jit` the Pallas td_vmm kernel's interpret
mode cannot run, so the reference's td matmuls go through its plain oracle
`td_vmm_signed_ref` (bit-exact with the kernel: every partial sum is an
integer).  Every primitive the reference runs op by op is compiled on
first use, which makes this file take about 90 s on the CPU.

Tolerances: losses rtol 1e-5; gradient norms rtol 5e-3 (bf16 gradients
summed in another order round differently, and the embedding's and LSQ
steps' sums reach 0.1% apart); parameters within 1e-7 + 1e-6 relative
except at most 3% of entries, which may differ by AdamW's sign flip
(`torch_train_parity.assert_params_close`: a bf16 gradient within
rounding of 0 changes sign).
"""
import torch_threads  # noqa: F401  (first: torch's threads under xdist)
import numpy as np
import pytest

from torch_train_parity import archs, assert_params_close, run_both

NAME = "qwen3-8b"


@pytest.mark.parametrize("mode", ["td", "quant"])
def test_bfloat16_train_steps_match_op_by_op_reference(mode, monkeypatch):
    ja, ta = archs(NAME, mode, "bfloat16")
    out, jp, tp = run_both(ja, ta, 2, jit=False, monkeypatch=monkeypatch)
    assert np.all(np.isfinite(out["tl"]))
    np.testing.assert_allclose(out["tl"], out["jl"], rtol=1e-5)
    np.testing.assert_allclose(out["tg"], out["jg"], rtol=5e-3)
    assert_params_close(jp, tp, out["lr"], atol=1e-7, max_flip_share=0.03)
