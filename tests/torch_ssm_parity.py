"""Shared helpers of the sub-quadratic families' parity tests
(`test_torch_ssm_models.py`, `test_torch_ssm_train.py`,
`test_torch_ssm_launch.py`): the zamba2-1.2b and rwkv6-1.6b smoke models
from the reference's converted init (the ``model`` fixture, one module
instance a name), their policies at precise, quant and td, numpy tokens,
and the two packages' forwards on the same inputs (the reference under
`jax.jit`, compiled once per policy, or op by op).  Not a test module
itself."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import repro.configs as jcfgs
from repro.models import get_api as jget_api
from repro.models import transformer as jtr
from repro.tdsim.policy import TDPolicy as JPolicy
from repro.tdsim.policy import quant_policy as jquant
import repro_torch.configs as tcfgs
from repro_torch import prng
from repro_torch.convert import params_from_jax
from repro_torch.models import transformer as ttr
from repro_torch.tdsim.policy import TDPolicy as TPolicy
from repro_torch.tdsim.policy import quant_policy as tquant

NAMES = ["zamba2-1.2b", "rwkv6-1.6b"]
MODES = ["precise", "quant", "td0"]
B = 2


@pytest.fixture(scope="module", params=NAMES)
def model(request):
    """(name, reference params, port params): the smoke model's quant
    init (precise mode reads the same tree without its step sizes)."""
    name = request.param
    cfg = jcfgs.get_smoke(name).model
    jp = jget_api(cfg)["init"](jax.random.key(0), cfg, jquant())
    return name, jp, params_from_jax(jax.device_get(jp), cfg, device="cpu")


def cfgs(name):
    return jcfgs.get_smoke(name).model, tcfgs.get_smoke(name).model


def pols(mode, sigma=0.0):
    if mode == "quant":
        return jquant(), tquant()
    if mode == "precise":
        return JPolicy(), TPolicy()
    return (JPolicy(mode="td", n_chain=48, sigma_chain=sigma),
            TPolicy(mode="td", n_chain=48, sigma_chain=sigma))


def tokens(seed, s, b=B):
    return np.random.default_rng(seed).integers(0, 128, (b, s)).astype(
        np.int32)


_JITTED: dict = {}


def forward_pair(name, jp, tp, jpol, tpol, toks, key=3, jit=True):
    """(port logits, reference logits) of ``toks`` under ``key``."""
    jc, tc = cfgs(name)

    def jf(p, t, k):
        return jtr.forward(p, {"tokens": t}, jc, jpol, key=k)[0]
    if jit:
        jf = _JITTED.setdefault((name, jpol), jax.jit(jf))
    jl = jf(jp, jnp.asarray(toks), jax.random.key(key))
    with torch.no_grad():
        tl, _, _ = ttr.forward(tp, {"tokens": torch.from_numpy(toks)}, tc,
                               tpol, key=prng.key(key))
    return tl.numpy(), np.asarray(jl)
