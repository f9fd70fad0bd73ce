"""Port parity of the MoE FFN (`models/ffn.moe_ffn`) and its expert matmul
(`td_linear.td_matmul_experts`: the reference's ``jax.vmap`` of
``td_matmul`` over the experts, one td_vmm launch over E lanes with a w a
lane, and its STE backward).

The reference runs on the CPU in float32 (its Pallas td_vmm in interpret
mode); both sides get the reference's `moe_init` parameters.  Tolerances:

* the expert matmul at sigma 0 in td mode: bit-exact (integer codes times
  the same scales); with noise, the criterion of
  `test_torch_td_vmm.py::test_noisy_outputs_agree_up_to_rare_tdc_flips`
  (at most 1% of entries differ, each by a multiple of the step s_a s_w
  tdc_q);
* the MoE's output at precise, quant and td at sigma 0: within 1e-5 (the
  f32 sums of the router, softmax and combine round in another order);
  the tokens each expert receives (the slots) bit-exact, also at a
  dropping capacity and with tied router probabilities; the aux losses
  within 1e-6 relative and ``moe_dropped`` exactly;
* the expert lanes' gradients (x, the weight stack, s_a, s_w) against
  ``jax.grad`` of the reference's `_expert_mm`: within 1e-5 relative.
"""
import torch_threads  # noqa: F401  (first: torch's threads under xdist)
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro.configs.base import MoECfg as JMoE
from repro.models import ffn as jffn
from repro.tdsim.policy import TDPolicy as JPolicy
from repro_torch import prng
from repro_torch.configs.base import MoECfg
from repro_torch.convert import tree_from_numpy
from repro_torch.models import ffn as tffn
from repro_torch.tdsim import td_linear as tlin
from repro_torch.tdsim.policy import TDPolicy

D, E, K_TOP, F = 64, 8, 2, 48
B, S = 2, 12


def _moe(cf=1.25):
    return (JMoE(num_experts=E, top_k=K_TOP, d_ff_expert=F,
                 capacity_factor=cf),
            MoECfg(num_experts=E, top_k=K_TOP, d_ff_expert=F,
                   capacity_factor=cf))


def _pols(mode, sigma=0.0, tdc_q=1):
    kw = dict(mode=mode, n_chain=48, sigma_chain=sigma, tdc_q=tdc_q)
    return JPolicy(**kw), TDPolicy(**kw)


def _params(mode, seed=0):
    jm, _ = _moe()
    jp = jffn.moe_init(jax.random.key(seed), D, jm, _pols(mode)[0])
    return jp, tree_from_numpy(jax.device_get(jp))


def _x(seed=1, shape=(B, S, D)):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _record(monkeypatch):
    """Record the (E, C, d) inputs each package's expert matmuls get."""
    seen = {"j": [], "t": []}
    j_mm, t_mm = jffn._expert_mm, tlin.td_matmul_experts

    def j_rec(xs, *a):
        seen["j"].append(np.asarray(xs))
        return j_mm(xs, *a)

    def t_rec(xs, *a):
        seen["t"].append(xs.detach().numpy().copy())
        return t_mm(xs, *a)
    monkeypatch.setattr(jffn, "_expert_mm", j_rec)
    monkeypatch.setattr(tlin, "td_matmul_experts", t_rec)
    return seen


def _both(jp, tp, x, cf, mode, monkeypatch, sigma=0.0, key=7):
    jm, tm = _moe(cf)
    jpol, tpol = _pols(mode, sigma)
    seen = _record(monkeypatch)
    jy, jaux = jffn.moe_ffn(jp, jnp.asarray(x), jm, jpol,
                            jax.random.key(key))
    ty, taux = tffn.moe_ffn(tp, torch.from_numpy(x), tm, tpol,
                            prng.key(key))
    return (np.asarray(jy), ty.numpy(), jax.device_get(jaux),
            {k: float(v) for k, v in taux.items()}, seen)


@pytest.mark.parametrize("mode,cf", [("precise", 1.25), ("quant", 1.25),
                                     ("td", 1.25), ("precise", 0.5),
                                     ("td", 0.5)])
def test_moe_ffn_matches_reference(monkeypatch, mode, cf):
    jp, tp = _params(mode)
    jy, ty, jaux, taux, seen = _both(jp, tp, _x(), cf, mode, monkeypatch)
    assert ty.shape == (B, S, D)
    np.testing.assert_allclose(ty, jy, rtol=0, atol=1e-5)
    # the same tokens in the same slots for every projection's input
    np.testing.assert_array_equal(seen["t"][0], seen["j"][0])
    assert len(seen["t"]) == len(seen["j"]) == 3
    assert taux["moe_dropped"] == float(jaux["moe_dropped"])
    if cf == 0.5:
        assert taux["moe_dropped"] > 0.2       # capacity 6 of 24 pairs
    for k in ("moe_aux", "moe_z"):
        np.testing.assert_allclose(taux[k], float(jaux[k]), rtol=1e-6)


def test_router_ties_choose_the_lower_expert(monkeypatch):
    """Equal router columns give equal probabilities: both packages take
    the lower expert ids first (``jax.lax.top_k``'s order), also through a
    dropping capacity."""
    jp, tp = _params("precise")
    w = np.asarray(jp["router"]["w"]).copy()
    w[:, 1:6] = w[:, [1]]          # experts 1..5 tie for every token
    w[:, 0] = -4.0 * np.abs(w[:, 0])
    jp = {**jp, "router": {"w": jnp.asarray(w)}}
    tp = {**tp, "router": {"w": torch.from_numpy(w)}}
    probs = np.array(jax.nn.softmax(jnp.asarray(_x()).reshape(-1, D)
                                     @ w, -1))
    want_v, want_i = jax.lax.top_k(jnp.asarray(probs), 3)
    got_v, got_i = tffn.top_k(torch.from_numpy(probs), 3)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    for cf in (1.25, 0.5):
        jy, ty, jaux, taux, seen = _both(jp, tp, _x(), cf, "precise",
                                         monkeypatch)
        np.testing.assert_array_equal(seen["t"][0], seen["j"][0])
        np.testing.assert_allclose(ty, jy, rtol=0, atol=1e-5)
        assert taux["moe_dropped"] == float(jaux["moe_dropped"])


def _expert_inputs(seed, cap=10):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((E, cap, D)).astype(np.float32),
            rng.standard_normal((E, cap, F)).astype(np.float32))


@pytest.mark.parametrize("sigma,tdc_q", [(0.0, 1), (1.5, 2)])
def test_expert_lanes_match_vmapped_reference(sigma, tdc_q):
    jp, tp = _params("td")
    xs, hs = _expert_inputs(3)
    jpol, tpol = _pols("td", sigma, tdc_q)
    for nm, x in (("wi", xs), ("wo", hs)):
        want = np.asarray(jffn._expert_mm(jnp.asarray(x), jp[nm], jp, nm,
                                          jpol, jax.random.key(11)))
        got = tlin.td_matmul_experts(torch.from_numpy(x), tp[nm],
                                     tp["s_a"], tp[f"s_{nm}"], tpol,
                                     prng.key(11)).numpy()
        assert got.shape == want.shape
        if sigma == 0.0:
            np.testing.assert_array_equal(got, want)
            continue
        step = float(tp["s_a"] * tp[f"s_{nm}"]) * tdc_q
        diff = (got - want) / step
        assert (diff != 0).mean() <= 0.01
        np.testing.assert_allclose(diff, np.round(diff), atol=1e-3)
        clean = tlin.td_matmul_experts(torch.from_numpy(x), tp[nm],
                                       tp["s_a"], tp[f"s_{nm}"],
                                       dataclasses.replace(tpol,
                                                           sigma_chain=0.0),
                                       prng.key(11)).numpy()
        assert (got != clean).mean() > 0.05      # the noise is there
        # lane e is the single td matmul at split(key, E)[e]
        e = 5
        one = tlin.td_matmul(torch.from_numpy(x[e]), tp[nm][e], tp["s_a"],
                             tp[f"s_{nm}"], tpol,
                             prng.split(prng.key(11), E)[e]).numpy()
        np.testing.assert_array_equal(got[e], one)


def test_keyless_lanes_are_seeded_from_zero_key():
    jp, tp = _params("td")
    xs, _ = _expert_inputs(4)
    jpol, tpol = _pols("td", 2.0, 1)
    want = np.asarray(jffn._expert_mm(jnp.asarray(xs), jp["wg"], jp, "wg",
                                      jpol, None))
    got = tlin.td_matmul_experts(torch.from_numpy(xs), tp["wg"], tp["s_a"],
                                 tp["s_wg"], tpol, None).numpy()
    step = float(tp["s_a"] * tp["s_wg"])
    assert ((got - want) / step != 0).mean() <= 0.01
    one = tlin.td_matmul(torch.from_numpy(xs[2]), tp["wg"][2], tp["s_a"],
                         tp["s_wg"], tpol, None).numpy()
    np.testing.assert_array_equal(got[2], one)


@pytest.mark.parametrize("mode", ["quant", "td"])
def test_expert_lane_gradients_match_reference(mode):
    """d/d(x, w, s_a, s_w) of sum(y * c) for a fixed random c, td at sigma
    0: the lanes' STE backward against jax.grad of `_expert_mm`."""
    jp, tp = _params("td")
    xs, _ = _expert_inputs(5)
    jpol, tpol = _pols(mode)
    c = np.random.default_rng(6).standard_normal((E, 10, F)).astype(
        np.float32)

    def jloss(x, w, s_a, s_w):
        p = {"s_a": s_a, "s_wi": s_w}
        return (jffn._expert_mm(x, w, p, "wi", jpol, jax.random.key(2))
                * c).sum()
    want = jax.grad(jloss, argnums=(0, 1, 2, 3))(
        jnp.asarray(xs), jp["wi"], jp["s_a"], jp["s_wi"])
    leaves = [torch.from_numpy(xs).requires_grad_(),
              tp["wi"].clone().requires_grad_(),
              tp["s_a"].clone().requires_grad_(),
              tp["s_wi"].clone().requires_grad_()]
    y = tlin.td_matmul_experts(*leaves, tpol, prng.key(2))
    got = torch.autograd.grad((y * torch.from_numpy(c)).sum(), leaves)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-5,
                                   atol=1e-5 * np.abs(w).max())
