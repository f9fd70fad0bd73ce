"""Port parity of the whole slice: greedy serving of the qwen3-8b smoke
model through each package's `build_prefill_step` / `build_serve_step`.

Both packages get the reference's parameters (`api["init"]`, converted by
`repro_torch.convert.params_from_jax`) and the same numpy prompts; then a
prefill and 6 greedy decode steps run in each.  Configurations: the smoke
model as ``--td`` sets it up (n_chain = min(576, d_model) = 64, one
segment per d_model contraction) and with n_chain = 48, where d_model 64
and d_ff 160 span several chain segments with tails.

Tolerances:
* float32 compute, "quant" and "td" at sigma = 0 (the policy built by
  hand, as ROADMAP's parity rule asks): tokens identical, prefill logits
  within 1e-4;
* "td" at the solved exact-regime policy (noise on): tokens identical;
* bfloat16 compute (the default), td at the solved policy: tokens
  identical and logits within one bf16 ulp at their magnitude.  The
  reference steps run op by op here, not under `jax.jit`: XLA's CPU
  compiler drops the bf16 rounding of a value that only feeds a
  conversion to f32 (ROADMAP §3), which changes the reference's own
  numbers, while the port rounds after every op as the JAX program says.
"""
import torch_threads  # noqa: F401  (first: torch's threads under xdist)
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
from repro.tdsim.policy import TDPolicy as JPolicy
from repro.tdsim.policy import quant_policy as jquant
import repro_torch.configs as tcfgs
from repro_torch.configs.base import ShapeCfg as TShape
from repro_torch.configs.base import TDExecCfg as TTD
from repro_torch.configs.base import TrainCfg as TTrain
from repro_torch.convert import params_from_jax
from repro_torch.launch import serve as tserve
from repro_torch.launch import steps as tsteps
from repro_torch.tdsim.policy import TDPolicy as TPolicy

B, PROMPT, GEN = 2, 8, 6


@pytest.fixture(scope="module")
def params():
    """Reference init (its structure is the same for quant and td)."""
    cfg = jcfgs.get_smoke("qwen3-8b").model
    jp = jget_api(cfg)["init"](jax.random.key(0), cfg, jquant())
    return jp, params_from_jax(jax.device_get(jp), cfg, device="cpu")


def _archs(mode, n_chain, dtype):
    ja = jcfgs.get_smoke("qwen3-8b")
    ta = tcfgs.get_smoke("qwen3-8b")
    ja = ja.replace(td=JTD(mode=mode, n_chain=n_chain),
                    train=JTrain(compute_dtype=dtype))
    ta = ta.replace(td=TTD(mode=mode, n_chain=n_chain),
                    train=TTrain(compute_dtype=dtype))
    return ja, ta


def _serve(params, mode, n_chain, dtype, jit, monkeypatch, sigma0=False):
    """Prefill + GEN decode steps in both packages; returns (reference
    logits, port logits, reference tokens, port tokens)."""
    ja, ta = _archs(mode, n_chain, dtype)
    if sigma0:
        # both packages' steps resolve their policy inside
        monkeypatch.setattr(jsteps.common, "resolve_arch_policy",
                            lambda a: JPolicy(mode="td", n_chain=n_chain))
        monkeypatch.setattr(tsteps.common, "resolve_arch_policy",
                            lambda a, device=None: TPolicy(
                                mode="td", n_chain=n_chain))
    jp, tp = params
    toks = tserve.prompts(1, B, PROMPT, ja.model.vocab)
    j_shape = JShape("serve", PROMPT + GEN, B, "decode")
    t_shape = TShape("serve", PROMPT + GEN, B, "decode")
    j_pre = jsteps.build_prefill_step(ja, j_shape)
    j_srv = jsteps.build_serve_step(ja, j_shape)
    if jit:
        j_pre, j_srv = jax.jit(j_pre), jax.jit(j_srv)
    t_pre = tsteps.build_prefill_step(ta, t_shape, device="cpu")
    t_srv = tsteps.build_serve_step(ta, t_shape, device="cpu")

    jl, js = j_pre(jp, {"tokens": jnp.asarray(toks)})
    tl, ts = t_pre(tp, {"tokens": torch.from_numpy(toks)})
    jt = jnp.argmax(jl[:, -1], -1).astype(jnp.int32)[:, None]
    tt = torch.argmax(tl[:, -1], -1).to(torch.int32)[:, None]
    j_out, t_out = [np.asarray(jt)], [tt.numpy()]
    for _ in range(GEN - 1):
        jt, js = j_srv(jp, jt, js)
        tt, ts = t_srv(tp, tt, ts)
        j_out.append(np.asarray(jt))
        t_out.append(tt.numpy())
    return (np.asarray(jl.astype(jnp.float32)), tl.float().numpy(),
            np.concatenate(j_out, 1), np.concatenate(t_out, 1))


@pytest.mark.parametrize("mode,n_chain", [("quant", 64), ("td", 64),
                                          ("td", 48)])
def test_float32_tokens_and_logits(params, monkeypatch, mode, n_chain):
    jl, tl, jt, tt = _serve(params, mode, n_chain, "float32", jit=True,
                            monkeypatch=monkeypatch, sigma0=mode == "td")
    np.testing.assert_array_equal(tt, jt)
    np.testing.assert_allclose(tl, jl, rtol=0, atol=1e-4)
    assert tt.shape == (B, GEN)


def test_solved_exact_regime_policy_tokens(params, monkeypatch):
    jl, tl, jt, tt = _serve(params, "td", 64, "float32", jit=True,
                            monkeypatch=monkeypatch)
    np.testing.assert_array_equal(tt, jt)


def test_bfloat16_default_compute_tokens_and_logits(params, monkeypatch):
    jl, tl, jt, tt = _serve(params, "td", 64, "bfloat16", jit=False,
                            monkeypatch=monkeypatch)
    np.testing.assert_array_equal(tt, jt)
    ulp = 2.0 ** (np.floor(np.log2(np.abs(jl).max())) - 7)
    np.testing.assert_allclose(tl, jl, rtol=0, atol=ulp)


def test_run_and_cli_on_cpu(capsys):
    """The port's own serve loop: seeded init stored in the compute dtype,
    numpy prompts, greedy tokens in range."""
    arch = tcfgs.get_smoke("qwen3-8b").replace(td=TTD(mode="td",
                                                      n_chain=64))
    stats = {}
    ids = tserve.run(arch, 2, 5, 3, seed=0, device="cpu", stats=stats)
    assert ids.shape == (2, 3) and ids.dtype == torch.int32
    assert int(ids.min()) >= 0 and int(ids.max()) < arch.model.vocab
    assert len(stats["decode_ms"]) == 2 and stats["prefill_ms"] > 0
    again = tserve.main(["--smoke", "--td", "td", "--device", "cpu",
                         "--batch", "2", "--prompt-len", "5", "--gen", "3"])
    torch.testing.assert_close(again, ids)
    assert "[serve] prefill(2x5)" in capsys.readouterr().out
    out = tserve.main(["--smoke", "--scheduler", "--adapt", "--device",
                       "cpu", "--streams", "2", "--capacity", "2",
                       "--prompt-len", "4", "--gen", "3"])
    assert out["requests"] == 2 and "adaptations" in out
    with pytest.raises(KeyError):
        tcfgs.get("no-such-arch")
