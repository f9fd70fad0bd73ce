"""Port parity of dbrx-132b (16 experts top-4 at its published widths):
the config against the reference's field by field, and the smoke model
(2 layers, d 64, 4/2 heads, 4 experts top-2 of 128) from the
reference's converted init, float32 compute, the reference under
`jax.jit`.

* the configs (`CONFIG` and `smoke()`), their matmul ledgers, and the
  registry: every architecture of the reference is registered, and an
  unknown name raises `KeyError` in both packages;
* forward and the train loss at quant and td at sigma 0 (the default
  ``capacity_factor`` 1.25): logits within 1e-4, the aux losses and the
  loss's metrics within 1e-6 relative (as `test_torch_moe_decoder.py`);
* prefill + greedy decode at a dropless capacity (``capacity_factor``
  8.0) with float32 caches, precise and td at sigma 0: tokens identical,
  logits within 1e-4 (as `test_torch_moe_decode.py`);
* two float32 train steps, cut to 1 layer, td at the solved policy
  (remat full, its config's): the tolerances of
  `torch_train_parity.check_float32_steps`.
"""
import torch_threads  # noqa: F401  (first: torch's threads under xdist)
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import repro.configs as jcfgs
from repro.models import get_api as jget_api
from repro.models import matmul_shapes as jshapes
from repro.models import transformer as jtransformer
from repro.tdsim.policy import TDPolicy as JPolicy
from repro.tdsim.policy import quant_policy as jquant
import repro_torch.configs as tcfgs
from repro_torch import prng
from repro_torch.convert import params_from_jax
from repro_torch.models import get_api as tget_api
from repro_torch.models import matmul_shapes as tshapes
from repro_torch.models import transformer as ttransformer
from repro_torch.tdsim.policy import TDPolicy as TPolicy
from repro_torch.tdsim.policy import quant_policy as tquant
from torch_train_parity import archs, check_float32_steps

NAME = "dbrx-132b"


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


def _cfgs(cf=None):
    jc, tc = jcfgs.get_smoke(NAME).model, tcfgs.get_smoke(NAME).model
    if cf is None:
        return jc, tc
    return tuple(dataclasses.replace(c, moe=dataclasses.replace(
        c.moe, capacity_factor=cf)) for c in (jc, tc))


def test_config_registry_and_ledger_match_reference():
    for get in ("get", "get_smoke"):
        ja, ta = getattr(jcfgs, get)(NAME), getattr(tcfgs, get)(NAME)
        assert dataclasses.asdict(ta.model) == dataclasses.asdict(ja.model)
        assert dataclasses.asdict(ta.train) == dataclasses.asdict(ja.train)
        assert ta.microbatch_by_shape == ja.microbatch_by_shape
        assert [(s.name, s.k, s.n_out, s.calls_per_token)
                for s in tshapes(ta.model)] == \
            [(s.name, s.k, s.n_out, s.calls_per_token)
             for s in jshapes(ja.model)]
    full = tcfgs.get(NAME).model
    assert (full.n_layers, full.d_model, full.n_heads, full.n_kv_heads,
            full.vocab, full.moe.num_experts, full.moe.top_k,
            full.moe.d_ff_expert) == (40, 6144, 48, 8, 100352, 16, 4, 10752)
    assert sorted(tcfgs.ARCH_NAMES) == sorted(jcfgs.ARCH_NAMES)
    for cfgs in (jcfgs, tcfgs):
        with pytest.raises(KeyError):
            cfgs.get("no-such-arch")
        with pytest.raises(KeyError):
            cfgs.get_smoke("no-such-arch")


@pytest.mark.parametrize("mode", ["quant", "td0"])
def test_forward_and_train_loss_match_reference(params, mode):
    jc, tc = _cfgs()
    jpol, tpol = _pols(mode)
    jp, tp = params
    toks = np.random.default_rng(4).integers(0, 128, (2, 12)).astype(
        np.int32)
    batch = {"tokens": toks, "labels": np.roll(toks, -1, 1)}
    jl, _, jaux = jax.jit(lambda p, t: jtransformer.forward(
        p, {"tokens": t}, jc, jpol, key=jax.random.key(3)))(
            jp, jnp.asarray(toks))
    tl, _, taux = ttransformer.forward(tp, {"tokens": torch.from_numpy(
        toks)}, tc, tpol, key=prng.key(3))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                               atol=1e-4)
    assert sorted(taux) == sorted(jaux)
    for k in jaux:
        np.testing.assert_allclose(float(taux[k]), float(jaux[k]),
                                   rtol=1e-6)
    _, jm = jax.jit(lambda p, b: jget_api(jc)["train_loss"](
        p, b, jc, jpol, jax.random.key(3)))(
            jp, {k: jnp.asarray(v) for k, v in batch.items()})
    _, tm = tget_api(tc)["train_loss"](
        tp, {k: torch.from_numpy(v) for k, v in batch.items()}, tc, tpol,
        prng.key(3))
    assert sorted(tm) == sorted(jm)
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-6)


@pytest.mark.parametrize("mode", ["precise", "td0"])
def test_prefill_and_decode_match_reference(params, mode):
    jc, tc = _cfgs(cf=8.0)
    jpol, tpol = _pols(mode)
    jp, tp = params
    prompt, gen = 6, 5
    toks = np.random.default_rng(7).integers(0, 128, (2, prompt)).astype(
        np.int32)
    japi, tapi = jget_api(jc), tget_api(tc)
    jl, js = jax.jit(lambda p, t: japi["prefill"](
        p, {"tokens": t}, jc, jpol, s_cache=prompt + gen,
        cache_dtype=jnp.float32))(jp, jnp.asarray(toks))
    jdec = jax.jit(lambda p, t, s: japi["decode_step"](p, t, s, jc, jpol))
    with torch.no_grad():
        tl, ts = tapi["prefill"](tp, {"tokens": torch.from_numpy(toks)}, tc,
                                 tpol, s_cache=prompt + gen,
                                 cache_dtype=torch.float32)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                                   atol=1e-4)
        jt = jnp.argmax(jl[:, -1], -1).astype(jnp.int32)[:, None]
        tt = torch.argmax(tl[:, -1], -1).to(torch.int32)[:, None]
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
        for _ in range(gen - 1):
            jlog, js = jdec(jp, jt, js)
            tlog, ts = tapi["decode_step"](tp, tt, ts, tc, tpol)
            jt = jnp.argmax(jlog, -1).astype(jnp.int32)[:, None]
            tt = torch.argmax(tlog, -1).to(torch.int32)[:, None]
            np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
            np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog),
                                       rtol=0, atol=1e-4)


def test_td_train_steps_match_reference(monkeypatch):
    ja, ta = archs(NAME, "td", "float32", remat="full", n_layers=1)
    check_float32_steps(ja, ta, monkeypatch)
