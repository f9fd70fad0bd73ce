"""Port parity of the whole train step (`launch.steps.build_train_step`):
forward with keys, remat "full", STE and flash backward, microbatch
accumulation and AdamW, two steps from the reference's converted init.

Configurations: the qwen3-8b and granite-8b smoke models in "quant" and
"td" (the solved exact-regime policy, noise on), 2 microbatches of the
global batch 4 x 16, float32 compute, the reference under `jax.jit`.
Tolerances: losses rtol 1e-6 and gradient norms rtol 1e-5 (f32 sums in
another order; the td noise matches bit for bit, see
`tests/test_torch_td_vmm.py`); parameters within 1e-7 + 1e-6 relative
after two steps, with at most 0.1% of entries allowed AdamW's sign flip
(`torch_train_parity.assert_params_close`; none occur on these inputs).
"""
import torch_threads  # noqa: F401  (first: torch's threads under xdist)
import numpy as np
import pytest

from torch_train_parity import archs, assert_params_close, run_both


@pytest.mark.parametrize("name", ["qwen3-8b", "granite-8b"])
@pytest.mark.parametrize("mode", ["quant", "td"])
def test_float32_train_steps_match_reference(name, mode, monkeypatch):
    ja, ta = archs(name, mode, "float32")
    out, jp, tp = run_both(ja, ta, 2, jit=True, monkeypatch=monkeypatch)
    assert np.all(np.isfinite(out["tl"]))
    np.testing.assert_allclose(out["tl"], out["jl"], rtol=1e-6)
    np.testing.assert_allclose(out["tg"], out["jg"], rtol=1e-5)
    assert_params_close(jp, tp, out["lr"], atol=1e-7, max_flip_share=1e-3)
