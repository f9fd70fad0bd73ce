"""Port parity of the sub-quadratic families' training: the zamba2-1.2b
and rwkv6-1.6b smoke models from the reference's converted init
(`torch_ssm_parity`), float32.

* `train_loss` and its gradients at precise, quant and td at sigma 0, the
  reference's `jax.value_and_grad` under `jax.jit`, with the tolerances
  of `torch_launch_parity.assert_grad_close` (a leaf the loss never
  reads, zamba2's mixer-only layers' ``ln2``, has the reference's zero
  gradient), the port's remat none, full and dots bit for bit alike;
* one AdamW update on the reference's gradients, leaf for leaf within
  1e-7 (rwkv6's ``mu/*``, ``mu_k`` and ``mu_r`` decayed, as the
  reference's rule by leaf name does);
* two train steps of each package's `build_train_step` (td at the solved
  policy and quant, 2 microbatches, remat full; the port's step gives a
  leaf without a gradient zeros) with the tolerances of
  `torch_train_parity.check_float32_steps`.
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
from repro.optim import adamw as jadamw
from repro.tdsim.policy import quant_policy as jquant
import repro_torch.configs as tcfgs
from repro_torch import prng
from repro_torch.checkpoint import ckpt
from repro_torch.convert import params_from_jax
from repro_torch.models import get_api as tget_api
from repro_torch.optim import adamw as tadamw

from torch_launch_parity import assert_grad_close
from torch_ssm_parity import MODES, cfgs, model, pols, tokens
from torch_train_parity import archs, check_float32_steps


def _batch():
    toks = tokens(7, 10)
    return {"tokens": toks, "labels": np.roll(toks, -1, 1)}


def _port_grads(tp, batch, tc, tpol, remat):
    tp = tadamw.tree_map(lambda p: p.detach().clone().requires_grad_(), tp)
    loss, metrics = tget_api(tc)["train_loss"](
        tp, {k: torch.from_numpy(v) for k, v in batch.items()}, tc, tpol,
        prng.key(3), remat=remat)
    loss.backward()
    names, leaves = ckpt._flatten(tp)
    # a leaf the loss never reads has no gradient here, a zero one in the
    # reference (and in the port's train step)
    return float(loss.detach()), metrics, names, [
        torch.zeros_like(p) if p.grad is None else p.grad for p in leaves]


@pytest.mark.parametrize("mode", MODES)
def test_train_loss_and_grads_match_reference(model, mode):
    name, jp, tp = model
    jc, tc = cfgs(name)
    jpol, tpol = pols(mode)
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
    if name == "zamba2-1.2b":
        unused = [n for n in jnames if n.endswith("ln2/scale")
                  and not n.startswith("layers/1/")]
        assert len(unused) == 2
        for n in unused:
            assert not np.asarray(jleaves[jnames.index(n)]).any()
    for r in ("none", "dots"):
        assert runs[r][0] == tl
        for n, a, b in zip(tnames, tg, runs[r][3]):
            assert torch.equal(a, b), (r, n)


def test_adamw_step_matches_reference_leaf_for_leaf(model):
    """One AdamW update of each package on the reference's gradients
    (quant mode), from zero moments: every leaf within 1e-7; the leaves
    the reference's rule by leaf name decays move under a zero gradient,
    the others stay."""
    name, jp, tp = model
    jc, tc = cfgs(name)
    batch = _batch()
    jg = jax.jit(jax.grad(lambda p, b: jget_api(jc)["train_loss"](
        p, b, jc, jquant(), jax.random.key(3))[0]))(
            jp, {k: jnp.asarray(v) for k, v in batch.items()})
    jg = jax.tree_util.tree_map(lambda g: g * 0.0 if g.ndim == 1 else g,
                                jg)
    tg = params_from_jax(jax.device_get(jg), jc, device="cpu")
    cfg = jcfgs.get_smoke(name).train
    jp2, _, _ = jadamw.apply_updates(jp, jg, jadamw.init_opt_state(jp), cfg)
    tp0 = tadamw.tree_map(lambda p: p.clone(), tp)
    tp2, _, _ = tadamw.apply_updates(tp0, tg, tadamw.init_opt_state(tp0),
                                     tcfgs.get_smoke(name).train)
    jnames, jvals, _ = jckpt._flatten(jp2)
    tnames, tvals = ckpt._flatten(tp2)
    _, before = ckpt._flatten(tp)
    assert tnames == jnames
    decayed = []
    for n, a, b, b0 in zip(jnames, jvals, tvals, before):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0,
                                   atol=1e-7, err_msg=n)
        if b0.ndim == 1 and not torch.equal(b, b0):
            decayed.append(n.split("/")[-1])
    want = {"zamba2-1.2b": set(), "rwkv6-1.6b": {"r", "k", "v", "w", "g",
                                                  "mu_k", "mu_r"}}[name]
    assert set(decayed) == want


@pytest.mark.parametrize("mode", ["td", "quant"])
def test_float32_train_steps_match_reference(model, mode, monkeypatch):
    name = model[0]
    ja, ta = archs(name, mode, "float32")
    check_float32_steps(ja, ta, monkeypatch)
