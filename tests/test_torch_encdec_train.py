"""Port parity of the enc-dec family's training: the seamless-m4t-large-v2
smoke model (d 64, frames of 48) from the reference's converted init.

* `train_loss` and its gradients with respect to every parameter, float32,
  the reference's `jax.value_and_grad` under `jax.jit`, at precise, quant
  and td at sigma 0 (2 + 2 layers, batch 2 x 6 tokens and 4 frames):
  loss within 1e-6 relative; each gradient leaf within 1e-4 of its
  largest entry, and an LSQ step's (a 0-d leaf: a sum over the whole
  layer, whose terms cancel) within 1e-3 relative (summation order:
  3e-5 and 1.4e-4 seen), and the port's remat none, full and
  dots give the same gradients bit for bit;
* two train steps through each package's `build_train_step` (1 encoder +
  1 decoder layer: the reference's td_vmm runs in interpret mode inside
  its jitted step, which compiles slowly), global batch 4 x 16 with 4
  frames from `SyntheticStream.frontend_batch`, 2 microbatches, remat
  "full", td at the solved policy (noise on) and quant, float32: the
  tolerances of `torch_train_parity.check_float32_steps`;
* one bf16 train step (the config's compute dtype) against the reference
  run op by op, td at the solved policy: the tolerances of
  `tests/test_torch_train_bf16.py`.
"""
import torch_threads  # noqa: F401  (first: torch's threads under xdist)
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import repro.configs as jcfgs
from repro.checkpoint import ckpt as jckpt
from repro.models import get_api as jget_api
from repro.tdsim.policy import TDPolicy as JPolicy
from repro.tdsim.policy import quant_policy as jquant
import repro_torch.configs as tcfgs
from repro_torch import prng
from repro_torch.checkpoint import ckpt
from repro_torch.convert import params_from_jax
from repro_torch.models import get_api as tget_api
from repro_torch.optim import adamw as tadamw
from repro_torch.tdsim.policy import TDPolicy as TPolicy
from repro_torch.tdsim.policy import quant_policy as tquant

from torch_launch_parity import assert_grad_close
from torch_train_parity import (archs, assert_params_close,
                                check_float32_steps, run_both)

NAME = "seamless-m4t-large-v2"


@pytest.fixture(scope="module")
def params():
    cfg = jcfgs.get_smoke(NAME).model
    jp = jget_api(cfg)["init"](jax.random.key(0), cfg, jquant())
    return jp, params_from_jax(jax.device_get(jp), cfg, device="cpu")


def _pols(mode):
    if mode == "quant":
        return jquant(), tquant()
    if mode == "precise":
        return JPolicy(), TPolicy()
    return JPolicy(mode="td", n_chain=48), TPolicy(mode="td", n_chain=48)


def _batch():
    rng = np.random.default_rng(11)
    toks = rng.integers(0, 128, (2, 6)).astype(np.int32)
    return {"tokens": toks, "labels": np.roll(toks, -1, 1),
            "embeds": rng.standard_normal((2, 4, 48)).astype(np.float32)}


def _port_grads(tp, batch, tc, tpol, remat):
    tp = tadamw.tree_map(lambda p: p.detach().clone().requires_grad_(), tp)
    loss, metrics = tget_api(tc)["train_loss"](
        tp, {k: torch.from_numpy(v) for k, v in batch.items()}, tc, tpol,
        prng.key(3), remat=remat)
    loss.backward()
    names, leaves = ckpt._flatten(tp)
    # a step size that precise mode never reads has no gradient here and a
    # zero one in the reference
    return float(loss.detach()), metrics, names, [
        torch.zeros_like(p) if p.grad is None else p.grad for p in leaves]


@pytest.mark.parametrize("mode", ["precise", "quant", "td0"])
def test_train_loss_and_grads_match_reference(params, mode):
    jc, tc = jcfgs.get_smoke(NAME).model, tcfgs.get_smoke(NAME).model
    jpol, tpol = _pols(mode)
    jp, tp = params
    batch = _batch()
    jfn = jax.jit(jax.value_and_grad(
        lambda p, b: jget_api(jc)["train_loss"](
            p, b, jc, jpol, jax.random.key(3), remat="full"),
        has_aux=True))
    (jl, jm), jg = jfn(jp, {k: jnp.asarray(v) for k, v in batch.items()})
    jnames, jleaves, _ = jckpt._flatten(jg)
    runs = {r: _port_grads(tp, batch, tc, tpol, r)
            for r in ("none", "full", "dots")}
    tl, tm, tnames, tg = runs["full"]
    assert sorted(tm) == sorted(jm) == ["ce", "loss"]
    np.testing.assert_allclose(tl, float(jl), rtol=1e-6)
    assert tnames == jnames
    for n, a, b in zip(jnames, jleaves, tg):
        assert_grad_close(b.numpy(), np.asarray(a), n)
    for r in ("none", "dots"):
        assert runs[r][0] == tl
        for n, a, b in zip(tnames, tg, runs[r][3]):
            assert torch.equal(a, b), (r, n)


@pytest.mark.parametrize("mode", ["td", "quant"])
def test_float32_train_steps_match_reference(mode, monkeypatch):
    ja, ta = archs(NAME, mode, "float32", n_layers=1)
    check_float32_steps(ja, ta, monkeypatch)


def test_bfloat16_train_step_matches_op_by_op_reference(monkeypatch):
    ja, ta = archs(NAME, "td", "bfloat16", n_layers=1)
    out, jp, tp = run_both(ja, ta, 1, jit=False, monkeypatch=monkeypatch)
    assert np.all(np.isfinite(out["tl"]))
    np.testing.assert_allclose(out["tl"], out["jl"], rtol=1e-5)
    np.testing.assert_allclose(out["tg"], out["jg"], rtol=5e-3)
    assert_params_close(jp, tp, out["lr"], atol=1e-7, max_flip_share=0.03)
