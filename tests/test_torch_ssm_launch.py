"""Port parity of the sub-quadratic families at their entry points and
policy options: the zamba2-1.2b and rwkv6-1.6b smoke models
(`torch_ssm_parity`), float32 compute.

* `serve.run` and `train.run` against the reference's steps and train
  driver on the same parameters and inputs (`torch_launch_parity`), and
  both CLIs;
* zamba2 under per-layer policies (quant 4/4 and td at sigma 0 by layer,
  quant 8/8 at the top: the shared block was initialised under the top
  policy and runs under it at every site), the reference under
  `jax.jit`, and under TD attention (quant heads at the shared sites, the
  reference op by op, as `tests/test_torch_td_attention.py` says why):
  logits within 1e-4, greedy tokens equal.
"""
import torch_threads  # noqa: F401  (first: torch's threads under xdist)
import dataclasses

import numpy as np
import torch

import jax
import jax.numpy as jnp
from repro.models import get_api as jget_api
from repro.tdsim.policy import NetworkPolicy as JNet
from repro.tdsim.policy import TDPolicy as JPolicy
from repro.tdsim.policy import quant_policy as jquant
from repro_torch import prng
from repro_torch.convert import params_from_jax
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as ttrain
from repro_torch.models import get_api as tget_api
from repro_torch.models import transformer as ttr
from repro_torch.tdsim.policy import NetworkPolicy as TNet
from repro_torch.tdsim.policy import TDPolicy as TPolicy
from repro_torch.tdsim.policy import quant_policy as tquant

from torch_launch_parity import serve_both, train_both
from torch_ssm_parity import cfgs, forward_pair, model, tokens


def test_serve_run_and_cli_match_reference(model, monkeypatch, capsys):
    name = model[0]
    got, want, n_front = serve_both(name, 2, 8, 6, monkeypatch)
    assert n_front == 0 and got.shape == (2, 6)
    np.testing.assert_array_equal(got, want)
    monkeypatch.undo()
    ids = tserve.main(["--arch", name, "--smoke", "--device", "cpu",
                       "--td", "td", "--batch", "1", "--prompt-len", "5",
                       "--gen", "3"])
    assert ids.shape == (1, 3)
    assert "[energy] td" in capsys.readouterr().out


def test_train_run_and_cli_match_reference(model, monkeypatch):
    name = model[0]
    tl, jl = train_both(name, 2, 16, 4, monkeypatch, n_micro=2)
    assert np.all(np.isfinite(tl))
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    monkeypatch.undo()
    losses = ttrain.main(["--arch", name, "--smoke", "--td", "td",
                          "--steps", "1", "--seq", "8", "--batch", "2",
                          "--device", "cpu"])
    assert len(losses) == 1 and np.all(np.isfinite(losses))


def _per_layer(pol_cls, quant, td, n_layers):
    layers = tuple(quant(4, 4) if i % 2 == 0 else
                   td(mode="td", n_chain=48) for i in range(n_layers))
    return pol_cls(layers=layers, top=quant(8, 8))


def test_zamba2_per_layer_policies_run_the_shared_block_at_the_top():
    """Layers at quant 4/4 and td (sigma 0) in turn, the top-level policy
    at quant 8/8: the shared block (initialised under the top policy)
    and lm_head run at 8/8 in both packages."""
    name = "zamba2-1.2b"
    jc, _ = cfgs(name)
    jpol = _per_layer(JNet, jquant, JPolicy, jc.n_layers)
    tpol = _per_layer(TNet, tquant, TPolicy, jc.n_layers)
    jp = jget_api(jc)["init"](jax.random.key(1), jc, jpol)
    tp = params_from_jax(jax.device_get(jp), jc, device="cpu")
    got, want = forward_pair(name, jp, tp, jpol, tpol, tokens(5, 13))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    # under the layer policy the shared block would read 4-bit codes
    wrong = dataclasses.replace(tpol, top=tquant(4, 4))
    with torch.no_grad():
        bad, _, _ = ttr.forward(tp, {"tokens": torch.from_numpy(
            tokens(5, 13))}, cfgs(name)[1], wrong, key=prng.key(3))
    assert float(np.abs(bad.numpy() - want).max()) > 1e-2


def test_zamba2_td_attention_matches_reference():
    """``--td-attn quant`` heads at the shared sites, the reference op by
    op: a forward, and a prefill and 3 decode steps."""
    name = "zamba2-1.2b"
    jc, tc = cfgs(name)
    heads = jc.n_heads
    jpol = JNet(layers=(jquant(),) * jc.n_layers, top=jquant(),
                attn=(jquant(),) * heads)
    tpol = TNet(layers=(tquant(),) * tc.n_layers, top=tquant(),
                attn=(tquant(),) * heads)
    jp = jget_api(jc)["init"](jax.random.key(2), jc, jquant())
    tp = params_from_jax(jax.device_get(jp), jc, device="cpu")
    toks = tokens(6, 9)
    got, want = forward_pair(name, jp, tp, jpol, tpol, toks, jit=False)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    japi, tapi = jget_api(jc), tget_api(tc)
    jl, js = japi["prefill"](jp, {"tokens": jnp.asarray(toks)}, jc, jpol,
                             s_cache=12, cache_dtype=jnp.float32)
    with torch.no_grad():
        tl, ts = tapi["prefill"](tp, {"tokens": torch.from_numpy(toks)}, tc,
                                 tpol, s_cache=12, cache_dtype=torch.float32)
        for _ in range(3):
            jt = jnp.argmax(jl[:, -1] if jl.ndim == 3 else jl, -1)
            tt = torch.argmax(tl[:, -1] if tl.dim() == 3 else tl, -1)
            np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
            jl, js = japi["decode_step"](jp, jt.astype(jnp.int32)[:, None],
                                         js, jc, jpol)
            tl, ts = tapi["decode_step"](tp, tt.to(torch.int32)[:, None], ts,
                                         tc, tpol)
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                                       atol=1e-4)
