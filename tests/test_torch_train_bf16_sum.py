"""Port parity of the bf16 gradient sum (``grad_allreduce_dtype=
"bfloat16"``) on the granite-moe-1b-a400m smoke model (cut to 1 layer,
d 64, 8 experts top-2) at its config's remat "dots": two train steps, 2
microbatches of the global batch 4 x 16, float32 compute, td at the
solved policy (noise on), against the reference's jitted step (its bf16
scan carry rounds every add, and the division by 2 is exact).

Tolerances as `tests/test_torch_train_step.py`: losses rtol 1e-6,
gradient norms rtol 1e-5, parameters within 1e-7 + 1e-6 relative with at
most 0.1% of entries allowed AdamW's sign flip; and the gradient norm
differs from the float32 sum's (the same loss).
"""
import torch_threads  # noqa: F401  (first: torch's threads under xdist)
import numpy as np
import torch

from repro_torch.configs.base import ShapeCfg as TShape
from repro_torch.data.synthetic import DataCfg, SyntheticStream
from repro_torch.launch import steps as tsteps
from repro_torch.optim import adamw as tadamw

from torch_train_parity import BATCH, SEQ, archs, assert_params_close, \
    init_pair, run_both

NAME = "granite-moe-1b-a400m"


def test_bf16_gradient_sum_matches_reference(monkeypatch):
    ja, ta = archs(NAME, "td", "float32", remat="dots", n_layers=1,
                   grad_dtype="bfloat16")
    assert ta.train.grad_allreduce_dtype == "bfloat16"
    out, jp, tp = run_both(ja, ta, 2, jit=True, monkeypatch=monkeypatch)
    assert np.all(np.isfinite(out["tl"]))
    np.testing.assert_allclose(out["tl"], out["jl"], rtol=1e-6)
    np.testing.assert_allclose(out["tg"], out["jg"], rtol=1e-5)
    assert_params_close(jp, tp, out["lr"], atol=1e-7, max_flip_share=1e-3)
    # the float32 sum's first step, in the port
    _, ta32 = archs(NAME, "td", "float32", remat="dots", n_layers=1)
    _, tp32 = init_pair(ja)
    step = tsteps.build_train_step(ta32, TShape("t", SEQ, BATCH, "train"),
                                   device="cpu")
    batch = SyntheticStream(DataCfg(vocab=ta.model.vocab, seq_len=SEQ,
                                    global_batch=BATCH, seed=0)).batch(0)
    _, _, m32 = step(tp32, tadamw.init_opt_state(tp32),
                     {k: torch.from_numpy(v) for k, v in batch.items()}, 0)
    assert float(m32["loss"]) == out["tl"][0]
    assert float(m32["grad_norm"]) != out["tg"][0]
