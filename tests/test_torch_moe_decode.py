"""Port parity of the MoE decoder's prefill and decode: the
granite-moe-1b-a400m smoke model (2 layers, d 64, 8 experts top-2) from
the reference's converted init, float32 compute, the reference under
`jax.jit`; and the port's own serve and train CLIs on the smoke MoE.

Prefill + greedy decode at a dropless capacity (``capacity_factor`` 8.0,
as `tests/test_models_smoke.py` runs the reference) with float32 caches,
precise, quant and td at sigma 0: tokens identical to the reference's
and logits within 1e-4; in precise mode the decode logits also equal
teacher forcing (the forward over the whole sequence) within 1e-4.
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
from repro.tdsim.policy import TDPolicy as JPolicy
from repro.tdsim.policy import quant_policy as jquant
import repro_torch.configs as tcfgs
from repro_torch.configs.base import TDExecCfg as TTD
from repro_torch.convert import params_from_jax
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as ttrain
from repro_torch.models import get_api as tget_api
from repro_torch.models import transformer as ttransformer
from repro_torch.tdsim.policy import TDPolicy as TPolicy
from repro_torch.tdsim.policy import quant_policy as tquant

NAME = "granite-moe-1b-a400m"


@pytest.fixture(scope="module")
def params():
    cfg = jcfgs.get_smoke(NAME).model
    jp = jget_api(cfg)["init"](jax.random.key(0), cfg, jquant())
    return jp, params_from_jax(jax.device_get(jp), cfg, device="cpu")


def _cfgs(cf):
    jc, tc = jcfgs.get_smoke(NAME).model, tcfgs.get_smoke(NAME).model
    return (dataclasses.replace(jc, moe=dataclasses.replace(
                jc.moe, capacity_factor=cf)),
            dataclasses.replace(tc, moe=dataclasses.replace(
                tc.moe, capacity_factor=cf)))


def _pols(mode):
    if mode == "quant":
        return jquant(), tquant()
    if mode == "precise":
        return JPolicy(), TPolicy()
    return JPolicy(mode="td", n_chain=48), TPolicy(mode="td", n_chain=48)


@pytest.mark.parametrize("mode", ["precise", "quant", "td0"])
def test_decode_matches_reference_and_teacher_forcing(params, mode):
    """Greedy prefill + decode with float32 caches; in precise mode each
    step's logits also equal the forward over the whole sequence (teacher
    forcing; the fake-quant modes round the cached rows apart from it)."""
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
        jt = jnp.argmax(jl[:, -1], -1).astype(jnp.int32)[:, None]
        tt = torch.argmax(tl[:, -1], -1).to(torch.int32)[:, None]
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
        seq, steps = [tt], [tl[:, -1]]
        for _ in range(gen - 1):
            jlog, js = jdec(jp, jt, js)
            tlog, ts = tapi["decode_step"](tp, tt, ts, tc, tpol)
            jt = jnp.argmax(jlog, -1).astype(jnp.int32)[:, None]
            tt = torch.argmax(tlog, -1).to(torch.int32)[:, None]
            np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
            np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog),
                                       rtol=0, atol=1e-4)
            seq.append(tt)
            steps.append(tlog)
        full = torch.cat([torch.from_numpy(toks)] + seq[:-1], 1)
        tf, _, _ = ttransformer.forward(tp, {"tokens": full}, tc, tpol)
    if mode == "precise":
        np.testing.assert_allclose(torch.stack(steps, 1).numpy(),
                                   tf[:, prompt - 1:].numpy(), rtol=0,
                                   atol=1e-4)


def test_serve_and_train_clis_on_cpu(capsys):
    """The port's own serve (fixed batch and engine) and train loops on
    the smoke MoE, seeded init, td at the solved policy."""
    arch = tcfgs.get_smoke(NAME).replace(td=TTD(mode="td", n_chain=64))
    ids = tserve.run(arch, 2, 5, 3, seed=0, device="cpu")
    assert ids.shape == (2, 3)
    assert int(ids.min()) >= 0 and int(ids.max()) < arch.model.vocab
    out = tserve.main(["--smoke", "--arch", NAME, "--td", "td", "--device",
                       "cpu", "--scheduler", "--streams", "3", "--capacity",
                       "2", "--prompt-len", "4", "--gen", "3"])
    assert out["requests"] == 3
    losses = ttrain.main(["--smoke", "--arch", NAME, "--td", "td",
                          "--steps", "1", "--seq", "16", "--batch", "4",
                          "--device", "cpu"])
    assert len(losses) == 1 and np.all(np.isfinite(losses))
    assert "[train] done." in capsys.readouterr().out
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ttransformer.forward_lanes(
            {}, {"tokens": torch.zeros((1, 2), dtype=torch.int64)},
            arch.model, TPolicy(mode="td"), torch.zeros((1, 2)), [(0, 0)],
            TPolicy(mode="td"))
