"""Port parity of the config-only decoders and the energy ledger: the
qwen2.5-3b (QKV bias, 2 KV heads) and qwen3-4b (qk-norm, head dim 32 at
smoke size) smoke models served through each package's prefill and decode
steps, and `model_api.matmul_shapes` of them and of granite-moe-1b-a400m
at published and smoke widths.

Both packages get the reference's parameters and the same numpy prompts;
float32 compute, the reference under `jax.jit`, td at sigma 0 (the
policy built by hand; the quant path is the qwen3-8b serve tests'):
tokens identical, prefill logits within 1e-4 and the caches' keys
within 1e-2 (bf16 caches).  The configs' fields equal the reference's;
the ledgers are equal entry for entry.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import repro.configs as jcfgs
from repro.configs.base import ShapeCfg as JShape
from repro.configs.base import TDExecCfg as JTD
from repro.configs.base import TrainCfg as JTrain
from repro.launch import steps as jsteps
from repro.models import get_api as jget_api
from repro.models.model_api import matmul_shapes as jshapes
from repro.tdsim.policy import TDPolicy as JPolicy
from repro.tdsim.policy import quant_policy as jquant
import repro_torch.configs as tcfgs
from repro_torch.configs.base import ShapeCfg as TShape
from repro_torch.configs.base import TDExecCfg as TTD
from repro_torch.configs.base import TrainCfg as TTrain
from repro_torch.convert import params_from_jax
from repro_torch.launch import serve as tserve
from repro_torch.launch import steps as tsteps
from repro_torch.models.model_api import matmul_shapes as tshapes
from repro_torch.tdsim.policy import TDPolicy as TPolicy

B, PROMPT, GEN = 2, 7, 5
NEW = ("qwen2.5-3b", "qwen3-4b", "granite-moe-1b-a400m")


@pytest.mark.parametrize("name", NEW)
def test_configs_and_ledgers_match_reference(name):
    for get in ("get", "get_smoke"):
        ja, ta = getattr(jcfgs, get)(name), getattr(tcfgs, get)(name)
        jd = dataclasses.asdict(ja.model)
        td = dataclasses.asdict(ta.model)
        assert td == jd
        assert dataclasses.asdict(ta.train) == dataclasses.asdict(ja.train)
        assert ta.microbatch_by_shape == ja.microbatch_by_shape
        assert [(s.name, s.k, s.n_out, s.calls_per_token)
                for s in tshapes(ta.model)] == \
            [(s.name, s.k, s.n_out, s.calls_per_token)
             for s in jshapes(ja.model)]
    assert name in tcfgs.ARCH_NAMES


@pytest.mark.parametrize("name", ["qwen2.5-3b", "qwen3-4b"])
def test_smoke_serve_matches_reference(name, monkeypatch):
    ja = jcfgs.get_smoke(name).replace(
        td=JTD(mode="td", n_chain=48), train=JTrain(compute_dtype="float32"))
    ta = tcfgs.get_smoke(name).replace(
        td=TTD(mode="td", n_chain=48), train=TTrain(compute_dtype="float32"))
    monkeypatch.setattr(jsteps.common, "resolve_arch_policy",
                        lambda a: JPolicy(mode="td", n_chain=48))
    monkeypatch.setattr(tsteps.common, "resolve_arch_policy",
                        lambda a, device=None: TPolicy(mode="td",
                                                        n_chain=48))
    cfg = ja.model
    jp = jget_api(cfg)["init"](jax.random.key(1), cfg, jquant())
    tp = params_from_jax(jax.device_get(jp), ta.model, device="cpu")
    toks = tserve.prompts(2, B, PROMPT, cfg.vocab)
    j_shape = JShape("serve", PROMPT + GEN, B, "decode")
    t_shape = TShape("serve", PROMPT + GEN, B, "decode")
    j_pre = jax.jit(jsteps.build_prefill_step(ja, j_shape))
    j_srv = jax.jit(jsteps.build_serve_step(ja, j_shape))
    t_pre = tsteps.build_prefill_step(ta, t_shape, device="cpu")
    t_srv = tsteps.build_serve_step(ta, t_shape, device="cpu")
    jl, js = j_pre(jp, {"tokens": jnp.asarray(toks)})
    with torch.no_grad():
        tl, ts = t_pre(tp, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                               atol=1e-4)
    jt = jnp.argmax(jl[:, -1], -1).astype(jnp.int32)[:, None]
    tt = torch.argmax(tl[:, -1], -1).to(torch.int32)[:, None]
    for _ in range(GEN - 1):
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
        jt, js = j_srv(jp, jt, js)
        with torch.no_grad():
            tt, ts = t_srv(tp, tt, ts)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    for jc, tc in zip(js["layers"], ts["layers"]):
        np.testing.assert_allclose(tc["k"].float().numpy(),
                                   np.asarray(jc["k"], np.float32),
                                   rtol=0, atol=1e-2)
