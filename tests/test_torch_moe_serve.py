"""Port parity of the MoE decoder's serving: the granite-moe-1b-a400m
smoke model (2 layers, d 64, 8 experts top-2) through the
continuous-batching engine against the reference's engine, from the
reference's converted init, float32 compute (the reference jits its
steps).  The CLIs on the smoke MoE are in `tests/test_torch_moe_decode.py`.

The engine runs at capacity 3 in quant mode and td at sigma 0: each
request's tokens, the step count and the completion order equal the
reference engine's, and the meter's J/token within rtol 1e-4.  At that
capacity a decode step's 3 rows share top_k = 2 slots an expert, so rows
of a batch can drop each other's tokens: the coupling the reference has.
"""
import numpy as np
import pytest

import jax
import repro.configs as jcfgs
from repro.configs.base import TDExecCfg as JTD
from repro.configs.base import TrainCfg as JTrain
from repro.launch import scheduler as jsched
from repro.models import common as jcommon
from repro.models import get_api as jget_api
from repro.tdsim.policy import TDPolicy as JPolicy
from repro.tdsim.policy import quant_policy as jquant
import repro_torch.configs as tcfgs
from repro_torch.configs.base import TDExecCfg as TTD
from repro_torch.configs.base import TrainCfg as TTrain
from repro_torch.convert import params_from_jax
from repro_torch.launch import scheduler as tsched
from repro_torch.models import common as tcommon
from repro_torch.tdsim.policy import TDPolicy as TPolicy

NAME = "granite-moe-1b-a400m"


@pytest.fixture(scope="module")
def params():
    cfg = jcfgs.get_smoke(NAME).model
    jp = jget_api(cfg)["init"](jax.random.key(0), cfg, jquant())
    return jp, params_from_jax(jax.device_get(jp), cfg, device="cpu")


LENS = [(3, 5), (7, 4), (5, 6), (4, 2), (6, 5), (2, 3)]


def _reqs(mod):
    rng = np.random.default_rng(11)
    return [mod.Request(rid=i,
                        prompt=rng.integers(3, 50, size=p).astype(np.int32),
                        max_new_tokens=g)
            for i, (p, g) in enumerate(LENS)]


@pytest.mark.parametrize("mode", ["quant", "td0"])
def test_engine_matches_reference_engine(params, monkeypatch, mode):
    td = "td" if mode == "td0" else mode
    ja = jcfgs.get_smoke(NAME).replace(
        td=JTD(mode=td, n_chain=64), train=JTrain(compute_dtype="float32"))
    ta = tcfgs.get_smoke(NAME).replace(
        td=TTD(mode=td, n_chain=64), train=TTrain(compute_dtype="float32"))
    if mode == "td0":
        monkeypatch.setattr(jcommon, "resolve_arch_policy",
                            lambda a: JPolicy(mode="td", n_chain=64))
        monkeypatch.setattr(tcommon, "resolve_arch_policy",
                            lambda a, device=None: TPolicy(mode="td",
                                                            n_chain=64))
    jeng = jsched.ContinuousBatchingEngine(ja, capacity=3, s_cache=16,
                                           params=params[0], kv_block=8)
    teng = tsched.ContinuousBatchingEngine(ta, capacity=3, s_cache=16,
                                           params=params[1], kv_block=8,
                                           device="cpu")
    jout = jeng.run(_reqs(jsched))
    tout = teng.run(_reqs(tsched))
    assert list(teng.done) == list(jeng.done)
    assert teng.steps_run == jeng.steps_run == tout["steps"]
    for rid, req in jeng.done.items():
        assert teng.done[rid].generated == req.generated, f"rid={rid}"
    assert tout["new_tokens"] == jout["new_tokens"]
    if teng.meter is not None:
        np.testing.assert_allclose(tout["j_per_token"], jout["j_per_token"],
                                   rtol=1e-4)
