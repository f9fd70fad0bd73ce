"""Port parity of two training flags, remat "dots" and the forward-only
loss eval (`steps.build_forward_eval`), on the granite-moe-1b-a400m smoke
model (2 layers, d 64, 8 experts top-2), the one config that trains with
"dots".  The bf16 gradient sum is `tests/test_torch_train_bf16_sum.py`.

* remat "dots" against "none" in the port: every gradient bit for bit,
  td at the solved policy (noise on) and quant, float32 (the recomputed
  td matmuls draw the same noise: it is a counter hash of the seed); the
  selective-checkpoint policy keeps the unbatched matmuls (``aten.mm``)
  and recomputes the experts' batched ones (``aten.bmm``).  Against the
  reference's "dots": `tests/test_torch_moe_train.py`.
* the forward eval: the train loss's metrics of the reference's
  `build_forward_eval` within rtol 1e-6 (quant and td at sigma 0, f32),
  with no gradient kept.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro.launch import steps as jsteps
from repro.tdsim.policy import TDPolicy as JPolicy
from repro.tdsim.policy import quant_policy as jquant
from repro_torch import prng
from repro_torch.launch import steps as tsteps
from repro_torch.models import common as tcommon
from repro_torch.models import get_api as tget_api
from repro_torch.models import transformer as ttransformer
from repro_torch.optim import adamw as tadamw
from repro_torch.tdsim.policy import TDPolicy as TPolicy
from repro_torch.tdsim.policy import quant_policy as tquant

from torch_train_parity import archs, init_pair

NAME = "granite-moe-1b-a400m"


@pytest.fixture(scope="module")
def pair():
    """The reference's init (the same in quant and td) and its port."""
    return init_pair(archs(NAME, "quant", "float32")[0])


def _grads(tp, ta, pol, remat, batch):
    cfg = ta.model
    leaves = [p for _, p in tadamw.tree_leaves_with_path(tp)]
    for p in leaves:
        p.requires_grad_(True)
        p.grad = None
    loss, _ = tget_api(cfg)["train_loss"](tp, batch, cfg, pol, prng.key(9),
                                          remat=remat)
    loss.backward()
    loss = loss.detach()
    out = [p.grad.clone() for p in leaves]
    for p in leaves:
        p.grad = None
        p.requires_grad_(False)
    return float(loss), out


@pytest.mark.parametrize("mode", ["td", "quant"])
def test_remat_dots_gradients_equal_none(pair, mode, monkeypatch):
    _, ta = archs(NAME, mode, "float32", remat="dots")
    tp = pair[1]
    pol = tcommon.resolve_arch_policy(ta, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, 128, (2, 16)).astype(np.int32))
    batch = {"tokens": toks, "labels": torch.roll(toks, -1, 1)}
    seen = []
    policy = ttransformer._dots_policy

    def record(ctx, op, *a, **k):
        d = policy(ctx, op, *a, **k)
        seen.append((op, d))
        return d
    monkeypatch.setattr(ttransformer, "_dots_policy", record)
    l_none, g_none = _grads(tp, ta, pol, "none", batch)
    assert not seen
    l_dots, g_dots = _grads(tp, ta, pol, "dots", batch)
    assert l_dots == l_none
    for a, b in zip(g_dots, g_none):
        assert torch.equal(a, b)
    saved = {op for op, d in seen if d ==
             torch.utils.checkpoint.CheckpointPolicy.MUST_SAVE}
    recomputed = {op for op, d in seen if d !=
                  torch.utils.checkpoint.CheckpointPolicy.MUST_SAVE}
    assert saved == {torch.ops.aten.mm.default}
    if mode == "quant":          # the experts' fake-quant products
        assert torch.ops.aten.bmm.default in recomputed


@pytest.mark.parametrize("mode", ["quant", "td0"])
def test_forward_eval_matches_reference(pair, mode):
    ja, ta = archs(NAME, "quant", "float32")
    jp, tp = pair
    jpol, tpol = ((jquant(), tquant()) if mode == "quant" else
                  (JPolicy(mode="td", n_chain=48),
                   TPolicy(mode="td", n_chain=48)))
    toks = np.random.default_rng(5).integers(0, 128, (2, 16)).astype(
        np.int32)
    batch = {"tokens": toks, "labels": np.roll(toks, -1, 1)}
    jev = jsteps.build_forward_eval(ja)
    jm = jax.jit(lambda p, b: jev(p, b, jpol, jax.random.key(4)))(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    tev = tsteps.build_forward_eval(ta)
    leaf = tp["layers"][0]["moe"]["wi"].requires_grad_(True)
    tm = tev(tp, {k: torch.from_numpy(v) for k, v in batch.items()}, tpol,
             prng.key(4))
    leaf.requires_grad_(False)
    assert sorted(tm) == sorted(jm) == ["ce", "loss", "moe_aux",
                                        "moe_dropped", "moe_z"]
    for k, v in tm.items():
        assert not v.requires_grad
        np.testing.assert_allclose(float(v), float(jm[k]), rtol=1e-6)
