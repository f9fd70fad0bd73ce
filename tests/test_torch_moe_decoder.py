"""Port parity of the MoE decoder: the granite-moe-1b-a400m smoke model
(2 layers, d 64, 8 experts top-2) through `transformer.forward`, the
train loss with its router losses, from the reference's converted init
(prefill and decode are `tests/test_torch_moe_decode.py`, the train step
`tests/test_torch_moe_train.py`, the engine
`tests/test_torch_moe_serve.py`).

The reference runs under `jax.jit` in float32.  Tolerances:

* forward at quant and td at sigma 0: logits within 1e-4, the aux losses
  (summed over the layers) and the train loss's metrics within 1e-6
  relative (XLA's jit takes a mean as a product with 1/n, an ulp off the
  division: ``moe_dropped`` 0.18749994 against the port's 0.1875).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import repro.configs as jcfgs
from repro.models import get_api as jget_api
from repro.models import transformer as jtransformer
from repro.tdsim.policy import TDPolicy as JPolicy
from repro.tdsim.policy import quant_policy as jquant
import repro_torch.configs as tcfgs
from repro_torch import prng
from repro_torch.convert import params_from_jax
from repro_torch.models import get_api as tget_api
from repro_torch.models import transformer as ttransformer
from repro_torch.tdsim.policy import TDPolicy as TPolicy
from repro_torch.tdsim.policy import quant_policy as tquant

NAME = "granite-moe-1b-a400m"
B, SEQ = 2, 12


@pytest.fixture(scope="module")
def params():
    cfg = jcfgs.get_smoke(NAME).model
    jp = jget_api(cfg)["init"](jax.random.key(0), cfg, jquant())
    return jp, params_from_jax(jax.device_get(jp), cfg, device="cpu")


def _pols(mode):
    if mode == "quant":
        return jquant(), tquant()
    return JPolicy(mode="td", n_chain=48), TPolicy(mode="td", n_chain=48)


def _tokens(seed=4, b=B, s=SEQ):
    return np.random.default_rng(seed).integers(0, 128, (b, s)).astype(
        np.int32)


@pytest.mark.parametrize("mode", ["quant", "td0"])
def test_forward_and_train_loss_match_reference(params, mode):
    jc, tc = jcfgs.get_smoke(NAME).model, tcfgs.get_smoke(NAME).model
    jpol, tpol = _pols(mode)
    jp, tp = params
    toks = _tokens()
    batch = {"tokens": toks, "labels": np.roll(toks, -1, 1)}
    jfwd = jax.jit(lambda p, t: jtransformer.forward(
        p, {"tokens": t}, jc, jpol, key=jax.random.key(3)))
    jl, _, jaux = jfwd(jp, jnp.asarray(toks))
    tl, _, taux = ttransformer.forward(tp, {"tokens": torch.from_numpy(
        toks)}, tc, tpol, key=prng.key(3))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                               atol=1e-4)
    assert sorted(taux) == sorted(jaux) == ["moe_aux", "moe_dropped",
                                            "moe_z"]
    for k in ("moe_aux", "moe_z", "moe_dropped"):
        np.testing.assert_allclose(float(taux[k]), float(jaux[k]),
                                   rtol=1e-6)
    jloss = jax.jit(lambda p, b: jget_api(jc)["train_loss"](
        p, b, jc, jpol, jax.random.key(3)))
    _, jm = jloss(jp, {k: jnp.asarray(v) for k, v in batch.items()})
    _, tm = tget_api(tc)["train_loss"](
        tp, {k: torch.from_numpy(v) for k, v in batch.items()}, tc, tpol,
        prng.key(3))
    assert sorted(tm) == sorted(jm)
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-6)
    # the router losses join the loss; the dropped share does not
    want = float(tm["ce"]) + float(tm["moe_aux"]) + float(tm["moe_z"])
    np.testing.assert_allclose(float(tm["loss"]), want, rtol=1e-6)
