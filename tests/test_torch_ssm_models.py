"""Port parity of the sub-quadratic families through `models.model_api`:
the zamba2-1.2b smoke model (3 layers: mamba2, a shared-attention site
with its SwiGLU, mamba2; d 64, 4 heads of 16) and the rwkv6-1.6b smoke
model (2 layers of time and channel mix; d 64), from the reference's
converted init (`torch_ssm_parity`), float32 compute, the reference under
`jax.jit`, inputs from a numpy seed.

* `forward` at precise, quant and td at sigma 0: logits within 1e-4;
* `prefill` + 5 greedy `decode_step`s with float32 caches: tokens equal
  to the reference's, logits and every cache leaf within 1e-4;
* decode equals teacher forcing (precise; a 6-token prefill, then the
  true tokens one at a time) within 1e-4, as
  `tests/test_models_smoke.py:52-84` asks of the reference;
* noisy td (sigma 1.5): the noise's mean and std over 4 keys within 10%
  of the reference's;
* `matmul_shapes` at the full and smoke configs equal to the reference's
  ledger; the converter's checks and round trip; the scheduler's
  refusal, and a clean `forward_lanes` lane equal to `forward`.
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
from repro.launch.scheduler import ContinuousBatchingEngine as JEngine
from repro.models import get_api as jget_api
from repro.models import matmul_shapes as jshapes
import repro_torch.configs as tcfgs
from repro_torch import prng
from repro_torch.checkpoint import ckpt
from repro_torch.convert import params_from_jax
from repro_torch.launch.scheduler import ContinuousBatchingEngine as TEngine
from repro_torch.models import get_api as tget_api
from repro_torch.models import matmul_shapes as tshapes
from repro_torch.models import transformer as ttr
from repro_torch.tdsim.policy import TDPolicy as TPolicy

from torch_ssm_parity import (B, MODES, NAMES, cfgs, forward_pair, model,
                              pols, tokens)


@pytest.mark.parametrize("mode", MODES)
def test_forward_matches_reference(model, mode):
    name, jp, tp = model
    got, want = forward_pair(name, jp, tp, *pols(mode), tokens(1, 21))
    assert got.shape == (B, 21, 128)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


@pytest.mark.parametrize("mode", MODES)
def test_prefill_and_decode_steps_match_reference(model, mode):
    name, jp, tp = model
    jc, tc = cfgs(name)
    jpol, tpol = pols(mode)
    prompt, gen = 7, 6
    toks = tokens(2, prompt)
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
    jlay, tlay = js["layers"], ts["layers"]
    assert len(tlay) == len(jlay) == jc.n_layers
    for jcache, tcache in zip(jlay, tlay):
        assert sorted(tcache) == sorted(jcache)
        for k in tcache:
            if k == "idx":
                assert tcache[k] == int(jcache[k]) == prompt + gen - 1
            else:
                assert tcache[k].dtype == torch.float32
                np.testing.assert_allclose(tcache[k].numpy(),
                                           np.asarray(jcache[k]), rtol=0,
                                           atol=1e-4, err_msg=k)


def test_decode_matches_teacher_forcing(model):
    """Precise mode, the port against itself: a prefill of 6 tokens, then
    the true tokens one at a time, against one forward over all 12."""
    name, _, tp = model
    _, tc = cfgs(name)
    api = tget_api(tc)
    pol = TPolicy()
    toks = torch.from_numpy(tokens(3, 12))
    with torch.no_grad():
        full, _, _ = ttr.forward(tp, {"tokens": toks}, tc, pol)
        lg, state = api["prefill"](tp, {"tokens": toks[:, :6]}, tc, pol,
                                   s_cache=12, cache_dtype=torch.float32)
        errs = [float((lg[:, -1] - full[:, 5]).abs().max())]
        for t in range(6, 11):
            out, state = api["decode_step"](tp, toks[:, t:t + 1], state, tc,
                                            pol)
            errs.append(float((out - full[:, t]).abs().max()))
    assert max(errs) < 1e-4, errs


def test_noisy_moments_match_reference(model):
    """td at sigma 1.5: the noise (noisy minus sigma-0 logits, over 4
    keys) held to the reference's by its mean and std (Box-Muller draws
    are not bit-reproducible across backends)."""
    name, jp, tp = model
    toks = tokens(4, 9)
    clean = forward_pair(name, jp, tp, *pols("td0"), toks)
    dj, dt = [], []
    for seed in range(4):
        t, j = forward_pair(name, jp, tp, *pols("td", 1.5), toks, key=seed)
        dt.append(t - clean[0])
        dj.append(j - clean[1])
    dj, dt = np.stack(dj), np.stack(dt)
    assert dj.std() > 1e-3
    np.testing.assert_allclose(dt.std(), dj.std(), rtol=0.1)
    assert abs(dt.mean() - dj.mean()) <= 0.1 * dj.std()


@pytest.mark.parametrize("name", NAMES)
def test_matmul_shapes_match_reference(name):
    for get in (lambda c: c.get(name), lambda c: c.get_smoke(name)):
        want = [dataclasses.astuple(s) for s in jshapes(get(jcfgs).model)]
        got = [dataclasses.astuple(s) for s in tshapes(get(tcfgs).model)]
        assert got == want
    full = tshapes(tcfgs.get(name).model)
    names = [s.name for s in full]
    if name == "zamba2-1.2b":
        assert names[:6] == ["attn.q", "attn.k", "attn.v", "attn.o",
                             "mamba.in", "mamba.out"]
        assert full[0].calls_per_token == 6
        assert (full[4].n_out, full[4].calls_per_token) == (8384, 32)
        # the reference's quirk: the SwiGLU counted at all 38 layers
        assert names[6] == "mlp.wi" and full[6].calls_per_token == 38
    else:
        assert names[:5] == ["rwkv.r", "rwkv.k", "rwkv.v", "rwkv.g",
                             "rwkv.o"]


def test_converter_checks_and_round_trip(model):
    name, jp, tp = model
    cfg = tcfgs.get_smoke(name).model
    names, vals, _ = jckpt._flatten(jp)
    tnames, tvals = ckpt._flatten(tp)
    assert tnames == names
    for n, a, b in zip(names, vals, tvals):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a), err_msg=n)
    host = jax.device_get(jp)
    with pytest.raises(ValueError, match="'layers'"):
        params_from_jax({**host, "layers": host["layers"][:1]}, cfg,
                        device="cpu")
    sub = "mamba" if name == "zamba2-1.2b" else "chanmix"
    broken = [dict(lp) for lp in host["layers"]]
    del broken[0][sub]
    with pytest.raises(ValueError, match="layer 0"):
        params_from_jax({**host, "layers": broken}, cfg, device="cpu")
    if name == "zamba2-1.2b":
        with pytest.raises(ValueError, match="shared_attn"):
            params_from_jax({k: v for k, v in host.items()
                             if k != "shared_attn"}, cfg, device="cpu")


def test_scheduler_and_forward_lanes_refuse(model):
    """Both packages' engines refuse a non-attention mixer before any
    work; the port's `forward_lanes` runs the family (each lane equal to
    its single forward bit for bit: `tests/test_torch_lm_sweep_families.py`
    holds the noisy lanes)."""
    name, _, tp = model
    for engine, cfgs in ((JEngine, jcfgs), (TEngine, tcfgs)):
        with pytest.raises(ValueError, match="pure-attention mixers"):
            engine(cfgs.get_smoke(name))
    cfg = tcfgs.get_smoke(name).model
    batch = {"tokens": torch.from_numpy(tokens(2, 4)).long()}
    keys = [prng.key(0), prng.key(1)]
    pol = TPolicy(mode="td", n_chain=48)
    out = ttr.forward_lanes(tp, batch, cfg, pol,
                            torch.zeros((2, cfg.n_layers)), keys, pol)
    with torch.no_grad():
        want = ttr.forward(tp, batch, cfg, pol, key=keys[1])[0]
    assert torch.equal(out[1], want)
