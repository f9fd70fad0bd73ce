"""Port parity of a decoder's stub frontend and of tied embeddings: the
internvl2-26b smoke model (2 layers, d 64, 4/2 heads, a vision adapter
from patches of 48) and the qwen3-8b smoke model with
``tie_embeddings=True``, from the reference's converted init, float32
compute, the reference under `jax.jit`.

* `train_loss` with 4 patches before 6 tokens (the logits of the patch
  positions skipped) and its gradients, at precise, quant and td at sigma
  0: loss within 1e-6 relative, each gradient leaf within 1e-4 of its
  largest entry and an LSQ step's (a 0-d leaf) within 1e-3 relative
  (summation order, as `tests/test_torch_encdec_train.py`);
* `prefill` with 8 patches + 4 greedy `decode_step`s, float32 caches:
  tokens identical, logits within 1e-4;
* tied embeddings (no lm_head; logits ``x @ embed.table.T``): the forward
  within 1e-4 at quant and td at sigma 0, loss and gradients as above;
* two float32 train steps through each package's `build_train_step` (td
  at the solved policy, 1 layer, 12 tokens after 4 patches): the
  tolerances of `torch_train_parity.check_float32_steps`;
* `serve.run` (8 patches, prompt 8, 6 new tokens) against the reference's
  steps with the port's cache size (the reference's own rule, prompt +
  gen rows, cannot hold the 8 patch positions: its prefill raises, held
  here), and `train.run` against the reference's (losses within 1e-5);
* `matmul_shapes` equal to the reference's (the adapter is not in the
  ledger), the converter's checks, the scheduler's refusal, the CLIs.
"""
import torch_threads  # noqa: F401  (first: torch's threads under xdist)
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import repro.configs as jcfgs
from repro.checkpoint import ckpt as jckpt
from repro.configs.base import ShapeCfg as JShape
from repro.launch import steps as jsteps
from repro.launch.scheduler import ContinuousBatchingEngine as JEngine
from repro.models import get_api as jget_api
from repro.models import matmul_shapes as jshapes
from repro.models import transformer as jtransformer
from repro.tdsim.policy import TDPolicy as JPolicy
from repro.tdsim.policy import quant_policy as jquant
import repro_torch.configs as tcfgs
from repro_torch import prng
from repro_torch.checkpoint import ckpt
from repro_torch.convert import params_from_jax
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as ttrain
from repro_torch.launch.scheduler import ContinuousBatchingEngine as TEngine
from repro_torch.models import get_api as tget_api
from repro_torch.models import matmul_shapes as tshapes
from repro_torch.models import transformer as ttransformer
from repro_torch.optim import adamw as tadamw
from repro_torch.tdsim.policy import TDPolicy as TPolicy
from repro_torch.tdsim.policy import quant_policy as tquant

from torch_launch_parity import (archs, assert_grad_close, serve_both,
                                 train_both)
from torch_train_parity import archs as train_archs
from torch_train_parity import check_float32_steps

NAME = "internvl2-26b"


def _cfgs(name):
    jc, tc = jcfgs.get_smoke(name).model, tcfgs.get_smoke(name).model
    if name == "qwen3-8b":
        jc = dataclasses.replace(jc, tie_embeddings=True)
        tc = dataclasses.replace(tc, tie_embeddings=True)
    return jc, tc


def _init(name):
    jc, tc = _cfgs(name)
    jp = jget_api(jc)["init"](jax.random.key(0), jc, jquant())
    return jp, params_from_jax(jax.device_get(jp), tc, device="cpu")


@pytest.fixture(scope="module")
def params():
    return {name: _init(name) for name in (NAME, "qwen3-8b")}


def _pols(mode):
    if mode == "quant":
        return jquant(), tquant()
    if mode == "precise":
        return JPolicy(), TPolicy()
    return JPolicy(mode="td", n_chain=48), TPolicy(mode="td", n_chain=48)


def _batch(name, n_vis=4, s=6):
    rng = np.random.default_rng(12)
    toks = rng.integers(0, 128, (2, s)).astype(np.int32)
    out = {"tokens": toks, "labels": np.roll(toks, -1, 1)}
    if name == NAME:
        out["embeds"] = rng.standard_normal((2, n_vis, 48)).astype(
            np.float32)
    return out


@pytest.mark.parametrize("name,mode", [
    (NAME, "precise"), (NAME, "quant"), (NAME, "td0"),
    ("qwen3-8b", "quant"), ("qwen3-8b", "td0")])
def test_train_loss_and_grads_match_reference(params, name, mode):
    jc, tc = _cfgs(name)
    jpol, tpol = _pols(mode)
    jp, tp = params[name]
    batch = _batch(name)
    jfn = jax.jit(jax.value_and_grad(
        lambda p, b: jget_api(jc)["train_loss"](p, b, jc, jpol,
                                                jax.random.key(3)),
        has_aux=True))
    (jl, jm), jg = jfn(jp, {k: jnp.asarray(v) for k, v in batch.items()})
    tp = tadamw.tree_map(lambda p: p.detach().clone().requires_grad_(), tp)
    tl, tm = tget_api(tc)["train_loss"](
        tp, {k: torch.from_numpy(v) for k, v in batch.items()}, tc, tpol,
        prng.key(3))
    tl.backward()
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-6)
    assert sorted(tm) == sorted(jm)
    jnames, jleaves, _ = jckpt._flatten(jg)
    tnames, tleaves = ckpt._flatten(tp)
    assert tnames == jnames
    assert ("adapter/w" in tnames) == (name == NAME)
    assert ("lm_head/w" in tnames) == (name == NAME)
    for n, a, p in zip(jnames, jleaves, tleaves):
        a = np.asarray(a)
        # a step size precise mode never reads: no gradient, the
        # reference's is zero
        b = torch.zeros_like(p) if p.grad is None else p.grad
        assert_grad_close(b.numpy(), a, n)


@pytest.mark.parametrize("mode", ["quant", "td0"])
def test_tied_forward_matches_reference(params, mode):
    jc, tc = _cfgs("qwen3-8b")
    jpol, tpol = _pols(mode)
    jp, tp = params["qwen3-8b"]
    toks = _batch("qwen3-8b", s=7)["tokens"]
    jl, _, _ = jax.jit(lambda p, t: jtransformer.forward(
        p, {"tokens": t}, jc, jpol, key=jax.random.key(5)))(
            jp, jnp.asarray(toks))
    with torch.no_grad():
        tl, _, _ = ttransformer.forward(
            tp, {"tokens": torch.from_numpy(toks)}, tc, tpol,
            key=prng.key(5))
    assert "lm_head" not in tp and tl.shape == (2, 7, tc.vocab)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                               atol=1e-4)


@pytest.mark.parametrize("mode", ["quant", "td0"])
def test_prefill_and_decode_with_patches_match_reference(params, mode):
    jc, tc = _cfgs(NAME)
    jpol, tpol = _pols(mode)
    jp, tp = params[NAME]
    n_vis, prompt, gen = 8, 6, 5
    b = _batch(NAME, n_vis=n_vis, s=prompt)
    s_cache = n_vis + prompt + gen
    japi, tapi = jget_api(jc), tget_api(tc)
    jl, js = jax.jit(lambda p, t, e: japi["prefill"](
        p, {"tokens": t, "embeds": e}, jc, jpol, s_cache=s_cache,
        cache_dtype=jnp.float32))(jp, jnp.asarray(b["tokens"]),
                                  jnp.asarray(b["embeds"]))
    jdec = jax.jit(lambda p, t, s: japi["decode_step"](p, t, s, jc, jpol))
    with torch.no_grad():
        tl, ts = tapi["prefill"](
            tp, {"tokens": torch.from_numpy(b["tokens"]),
                 "embeds": torch.from_numpy(b["embeds"])}, tc, tpol,
            s_cache=s_cache, cache_dtype=torch.float32)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                                   atol=1e-4)
        assert ts["layers"][0]["idx"] == n_vis + prompt
        jt = jnp.argmax(jl[:, -1], -1).astype(jnp.int32)[:, None]
        tt = torch.argmax(tl[:, -1], -1).to(torch.int32)[:, None]
        for _ in range(gen - 1):
            jlog, js = jdec(jp, jt, js)
            tlog, ts = tapi["decode_step"](tp, tt, ts, tc, tpol)
            np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog),
                                       rtol=0, atol=1e-4)
            jt = jnp.argmax(jlog, -1).astype(jnp.int32)[:, None]
            tt = torch.argmax(tlog, -1).to(torch.int32)[:, None]
            np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))


def test_float32_train_steps_match_reference(monkeypatch):
    ja, ta = train_archs(NAME, "td", "float32", n_layers=1)
    check_float32_steps(ja, ta, monkeypatch)


def test_serve_run_matches_reference_steps(monkeypatch):
    got, want, n_front = serve_both(NAME, 2, 8, 6, monkeypatch)
    assert n_front == 8 and got.shape == (2, 6)
    np.testing.assert_array_equal(got, want)
    # the reference's serve.run sizes the cache at prompt + gen (14 rows)
    # and cannot fit 8 patches + 8 prompt tokens in it
    ja, _ = archs(NAME)
    pre = jsteps.build_prefill_step(ja, JShape("serve", 14, 2, "decode"))
    jp = jget_api(ja.model)["init"](jax.random.key(0), ja.model, jquant())
    with pytest.raises(TypeError, match="dynamic_update_slice"):
        pre(jp, {"tokens": jnp.zeros((2, 8), jnp.int32),
                 "embeds": jnp.zeros((2, 8, 48), jnp.bfloat16)})


def test_train_run_matches_reference_run(monkeypatch):
    tl, jl = train_both(NAME, 2, 16, 4, monkeypatch)
    assert len(tl) == 2 and np.all(np.isfinite(tl))
    np.testing.assert_allclose(tl, jl, rtol=1e-5)


@pytest.mark.parametrize("full", [False, True])
def test_matmul_shapes_match_reference(full):
    for name in (NAME, "qwen3-8b"):
        jc = (jcfgs.get(name) if full else jcfgs.get_smoke(name)).model
        tc = (tcfgs.get(name) if full else tcfgs.get_smoke(name)).model
        jc = dataclasses.replace(jc, tie_embeddings=name != NAME)
        tc = dataclasses.replace(tc, tie_embeddings=name != NAME)
        assert [dataclasses.astuple(s) for s in tshapes(tc)] == \
            [dataclasses.astuple(s) for s in jshapes(jc)]


def test_converter_checks_frontend_and_tied_trees(params):
    host = jax.device_get(params[NAME][0])
    cfg = tcfgs.get_smoke(NAME).model
    with pytest.raises(ValueError, match="lacks 'adapter'"):
        params_from_jax({k: v for k, v in host.items() if k != "adapter"},
                        cfg, device="cpu")
    with pytest.raises(ValueError, match="has 'lm_head'"):
        params_from_jax(host, dataclasses.replace(cfg, tie_embeddings=True),
                        device="cpu")


def test_scheduler_refuses_frontends():
    """Both packages' engines refuse a stub-frontend model."""
    for engine, cfgs in ((JEngine, jcfgs), (TEngine, tcfgs)):
        with pytest.raises(ValueError, match="frontends"):
            engine(cfgs.get_smoke(NAME))


def test_serve_and_train_clis_on_cpu(capsys):
    ids = tserve.main(["--smoke", "--arch", NAME, "--td", "td", "--device",
                       "cpu", "--batch", "2", "--prompt-len", "6", "--gen",
                       "3"])
    assert ids.shape == (2, 3)
    assert int(ids.min()) >= 0 and int(ids.max()) < 128
    losses = ttrain.main(["--smoke", "--arch", NAME, "--td", "td",
                          "--steps", "1", "--seq", "16", "--batch", "4",
                          "--device", "cpu"])
    assert len(losses) == 1 and np.all(np.isfinite(losses))
    assert "[train] done." in capsys.readouterr().out
