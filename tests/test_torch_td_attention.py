"""Port parity: TD attention (`tdsim/td_attention.py`), its wiring into
`models/attention`, policy resolution with ``td_attn``, and the serve and
train CLIs with ``--td-attn``.

The reference runs as `tests/test_attention_engine.py` runs it: td_vmm's
Pallas kernel in interpret mode under ``jax.vmap``.  Inputs come from
numpy with a seed.  What is held exactly and what to a tolerance:

* bit-exact: `_quant_dyn`'s codes and steps (ties, zeros and -0
  included); at sigma 0 the q, k and v codes and the QK^T integer scores
  of a whole call; the port's lane calls against one `td_vmm_seeded` a
  lane at the lane seeds (noise included); clean heads beside a noisy
  one; the STE gradient against the clean-attention gradient; the smoke
  serve's tokens with ``--td-attn quant``, and the smoke MoE's with
  ``--td-attn td`` at sigma 0;
* the output at sigma 0 within 2e-5 absolute: the softmax's ``exp`` and
  sums differ by an ulp between XLA and torch, so a probability code can
  flip at a rounding tie (one code moves the output by s_p * s_v);
* noisy outputs by moments (the Box-Muller ``log``/``cos`` differ by
  ulps, ROADMAP §3): the mean and standard deviation of the noise's
  effect within 5% of the reference's;
* the clean-attention gradient within 1e-6 of the reference's
  ``_clean_attention`` VJP; a smoke train step's loss within 1e-5 and
  gradient norm within 1e-4 relative, its parameters after AdamW as
  `tests/test_torch_train_step.py` holds them (1e-7 + 1e-6 relative, at
  most 0.1% of entries allowed AdamW's sign flip).

Model-level comparisons run the reference op by op, not under
`jax.jit`: XLA's CPU compiler turns `_quant_dyn`'s division by the
constant 2^(b-1) - 1 into a multiply by its reciprocal, an ulp off, which
moves codes at near ties (1.71 in the smoke prefill's logits; ROADMAP
§3).  The port divides as the reference's program is written, and equals
its op-by-op run.
"""
import torch_threads  # noqa: F401  (first: torch's threads under xdist)
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import repro.configs as jcfgs
from repro.configs.base import TDExecCfg as JTD
from repro.launch import serve as jserve
from repro.models import attention as jattn
from repro.models import common as jcommon
from repro.tdsim import td_attention as jta
from repro.tdsim.policy import TDPolicy as JPolicy
import repro_torch.configs as tcfgs
from repro_torch import convert
from repro_torch.configs.base import TDExecCfg as TTD
from repro_torch.kernels.flash_attn.ops import _masked_attn
from repro_torch.kernels.td_vmm import ops as tops
from repro_torch.kernels.td_vmm import ref as tref
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as ttrain
from repro_torch.models import attention as tattn
from repro_torch.models import common as tcommon
from repro_torch.tdsim import td_attention as tta
from repro_torch.tdsim.policy import TDPolicy

from torch_train_parity import (_oracle_td_vmm, archs, assert_params_close,
                                 run_both)

B, HQ, HKV, D = 2, 4, 2, 16


def _qkv(seed, b, sq, skv, hq=HQ, hkv=HKV, d=D):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, sq, hq, d)).astype(np.float32),
            rng.standard_normal((b, skv, hkv, d)).astype(np.float32),
            rng.standard_normal((b, skv, hkv, d)).astype(np.float32))


def _pols(mode, bits, n_chain, sigma=0.0, q=1):
    kw = dict(mode=mode, bits_a=bits, bits_w=bits, n_chain=n_chain,
              sigma_chain=sigma, tdc_q=q)
    return JPolicy(**kw), TDPolicy(**kw)


def _both(q, k, v, jpol, tpol, causal=True, kv_len=None, q_offset=None,
          key=(0, 0)):
    """td_attention in both packages on the same inputs and key."""
    jkw, tkw = dict(causal=causal), dict(causal=causal)
    if kv_len is not None:
        jkw["kv_len"] = jnp.asarray(kv_len, jnp.int32)
        tkw["kv_len"] = torch.tensor(kv_len, dtype=torch.int32)
    if q_offset is not None:
        jkw["q_offset"] = jnp.asarray(q_offset, jnp.int32)
        tkw["q_offset"] = q_offset
    want = jta.td_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            jpol, jnp.asarray(key, jnp.uint32), **jkw)
    got = tta.td_attention(torch.from_numpy(q), torch.from_numpy(k),
                           torch.from_numpy(v), tpol, key, **tkw)
    return np.asarray(want), got.numpy()


@pytest.mark.parametrize("bits", [2, 4, 8])
def test_quant_dyn_codes_bit_exact_with_ties_zeros_and_negative_zero(bits):
    levels = 2 ** (bits - 1) - 1
    rng = np.random.default_rng(bits)
    x = rng.standard_normal((2, 3, 5, 8)).astype(np.float32)
    # block (0, 0): max |x| = levels, so the step is 1 and these sit on
    # rounding ties; block (0, 1): all zeros; -0 in block (1, 0)
    x[0, 0] = 0.0
    x[0, 0, 0, :6] = [levels, 0.5, 1.5, -2.5, -0.5, -levels - 0.5]
    x[0, 1] = 0.0
    x[1, 0, 0, :2] = [-0.0, 0.0]
    jc, js = jta._quant_dyn(jnp.asarray(x), bits, (2, 3))
    tc, ts = tta._quant_dyn(torch.from_numpy(x), bits, (2, 3))
    assert tc.dtype == torch.int32
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert tc[0, 0, 0, :6].tolist() == list(np.asarray(jc)[0, 0, 0, :6])
    assert float(ts[0, 1].reshape(())) == np.float32(1e-8)


class _Spy:
    """Records the lane calls' codes and outputs of one package."""

    def __init__(self, monkeypatch):
        self.calls = []
        tfn, jfn = tta.td_ops.td_vmm_lanes, jta._lane_vmm

        def tspy(x, w, pol, sigma, tdc_q, seeds):
            out = tfn(x, w, pol, sigma, tdc_q, seeds)
            self.calls.append(("torch", x, w, pol, sigma, tdc_q, seeds, out))
            return out

        def jspy(pol, x, w, sigma, tdc_q, seeds):
            out = jfn(pol, x, w, sigma, tdc_q, seeds)
            self.calls.append(("jax", x, w, pol, sigma, tdc_q, seeds, out))
            return out

        monkeypatch.setattr(tta.td_ops, "td_vmm_lanes", tspy)
        monkeypatch.setattr(jta, "_lane_vmm", jspy)

    def side(self, name):
        return [c[1:] for c in self.calls if c[0] == name]


CASES = {  # (sq, skv, causal, kv_len, q_offset)
    "causal": (12, 12, True, None, None),
    "kv_len_short": (12, 12, True, [12, 7], None),
    "not_causal_kv_len": (10, 14, False, [14, 9], None),
    "decode_partly_filled_cache": (1, 16, True, [10, 10], 9),
}


@pytest.mark.parametrize("mode", ["td", "quant"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_sigma0_codes_and_scores_exact_output_close(case, mode, monkeypatch):
    sq, skv, causal, kv_len, q_off = CASES[case]
    q, k, v = _qkv(1, B, sq, skv)
    jpol, tpol = _pols(mode, 8, 8)
    spy = _Spy(monkeypatch)
    want, got = _both(q, k, v, jpol, tpol, causal, kv_len, q_off)
    (jqk, jpv), (tqk, tpv) = spy.side("jax"), spy.side("torch")
    # QK^T: q codes, k^T codes (repeated over the GQA group), scores
    for t, j in ((tqk[0], jqk[0]), (tqk[1], jqk[1]), (tqk[-1], jqk[-1])):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    # PV: v codes (the probability codes may flip at a tie)
    np.testing.assert_array_equal(tpv[1].numpy(), np.asarray(jpv[1]))
    assert tqk[-1].shape == (B * HQ, sq, skv)
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-5)


def test_lane_calls_equal_single_td_vmm_seeded_calls(monkeypatch):
    q, k, v = _qkv(2, B, 9, 11)
    pols = tuple(TDPolicy(mode="td", bits_a=4, bits_w=4, n_chain=8,
                          sigma_chain=0.7 * h, tdc_q=1 + h % 2)
                 for h in range(HQ))
    spy = _Spy(monkeypatch)
    tta.td_attention(torch.from_numpy(q), torch.from_numpy(k),
                     torch.from_numpy(v), pols, (3, 4), kv_len=torch.tensor(
                         [11, 6], dtype=torch.int32), q_offset=2)
    seed = tref.derive_seed((3, 4))
    for i, (x, w, pol, sigma, tdc_q, seeds, out) in enumerate(
            spy.side("torch")):
        lanes = x.shape[0]
        assert lanes == B * HQ and w.shape[0] == lanes
        salt = 0 if i == 0 else tref.GOLDEN
        want_seeds = [tref._hash32_int(seed ^ lane ^ salt)
                      for lane in range(lanes)]
        assert seeds.tolist() == want_seeds
        for lane in range(lanes):
            h = lane % HQ
            assert float(sigma[lane]) == np.float32(pols[h].sigma_chain)
            one = tops.td_vmm_seeded(x[lane], w[lane], pols[h],
                                     want_seeds[lane])
            assert torch.equal(out[lane], one), (i, lane)


def test_heterogeneous_heads_clean_heads_bit_identical():
    q, k, v = _qkv(3, 1, 16, 16)
    base = TDPolicy(mode="td", bits_a=8, bits_w=8, n_chain=D)
    args = [torch.from_numpy(a) for a in (q, k, v)]
    o_clean = tta.td_attention(*args, base, (0, 5))
    o_het = tta.td_attention(*args, tuple(
        base.replace(sigma_chain=5.0 if h == 2 else 0.0)
        for h in range(HQ)), (0, 5))
    for h in range(HQ):
        delta = float((o_het[:, :, h] - o_clean[:, :, h]).abs().max())
        if h == 2:
            assert delta > 1e-3
        else:
            assert delta == 0.0, h


def test_noisy_outputs_match_reference_by_moments():
    q, k, v = _qkv(4, B, 24, 24)
    jpol, tpol = _pols("td", 4, 8, sigma=2.0, q=2)
    jclean, tclean = _pols("td", 4, 8)
    want, got = _both(q, k, v, jpol, tpol, key=(0, 9))
    want0, got0 = _both(q, k, v, jclean, tclean, key=(0, 9))
    dj, dt = want - want0, got - got0
    assert np.abs(dj).max() > 1e-2          # the noise acts
    for stat in (np.mean, np.std, lambda a: np.mean(np.abs(a))):
        sj, st = float(stat(dj)), float(stat(dt))
        assert abs(st - sj) <= 0.05 * max(abs(sj), float(np.std(dj))), \
            (st, sj)


def test_ste_gradient_is_clean_attention_gradient():
    q, k, v = _qkv(5, 1, 20, 20)
    tpol = TDPolicy(mode="td", bits_a=8, bits_w=8, n_chain=D,
                    sigma_chain=3.0)
    g = np.random.default_rng(6).standard_normal(q.shape).astype(np.float32)
    kv_len = torch.full((1,), 20, dtype=torch.int32)
    q_off = torch.zeros((1,), dtype=torch.int32)
    grads = []
    for fn in (lambda a, b, c: tta.td_attention(a, b, c, tpol, (1, 2)),
               lambda a, b, c: _masked_attn(a, b, c, kv_len, q_off, True)):
        leaves = [torch.from_numpy(t).requires_grad_() for t in (q, k, v)]
        fn(*leaves).backward(torch.from_numpy(g))
        grads.append([t.grad for t in leaves])
    for a, b in zip(*grads):
        assert torch.equal(a, b)
    _, vjp = jax.vjp(lambda a, b, c: jta._clean_attention(
        a, b, c, jnp.full((1,), 20, jnp.int32), jnp.zeros((), jnp.int32),
        True), *(jnp.asarray(t) for t in (q, k, v)))
    for want, got in zip(vjp(jnp.asarray(g)), grads[0]):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-6)


def test_td_attention_rejects_what_the_reference_rejects():
    q, k, v = (torch.from_numpy(a) for a in _qkv(7, 1, 4, 4))
    with pytest.raises(ValueError, match="head policies for"):
        tta.td_attention(q, k, v, (TDPolicy(mode="td"),) * 3)
    with pytest.raises(ValueError, match="mode 'quant'"):
        tta.td_attention(q, k, v, TDPolicy(mode="precise"))
    mixed = (TDPolicy(mode="td", bits_a=8),) + (TDPolicy(mode="td"),) * 3
    with pytest.raises(ValueError, match="must share"):
        tta.td_attention(q, k, v, mixed)


@pytest.mark.parametrize("mode", ["quant", "td"])
def test_attention_prefill_and_decode_match_reference(mode):
    """`attention()` with head policies: a 7-token prefill into a 12-token
    cache, then two decode steps, against the reference's."""
    cfg = jcfgs.get_smoke("qwen3-8b").model
    tcfg = tcfgs.get_smoke("qwen3-8b").model
    jq, tq = _pols("quant", 4, 64)
    jhead, thead = _pols(mode, 4, cfg.hd)
    jp = jattn.attn_init(jax.random.PRNGKey(0), cfg, jq)
    tp = convert.tree_from_numpy(jax.device_get(jp))
    rng = np.random.default_rng(8)
    x = rng.standard_normal((2, 7, cfg.d_model)).astype(np.float32)
    jc = jattn.init_cache(2, 12, cfg, jnp.float32)
    tc = tattn.init_cache(2, 12, tcfg, torch.float32, device="cpu")
    key = jax.random.PRNGKey(11)
    tkey = tuple(int(w) for w in np.asarray(jax.random.key_data(key)))
    for step in range(3):
        n = 7 if step == 0 else 1
        xs = x if step == 0 else rng.standard_normal(
            (2, 1, cfg.d_model)).astype(np.float32)
        pos = np.arange(n) + (0 if step == 0 else 6 + step)
        yj, jc = jattn.attention(jp, jnp.asarray(xs), cfg, jq,
                                 jnp.asarray(pos), cache=jc, key=key,
                                 attn_pols=(jhead,) * cfg.n_heads)
        yt, tc = tattn.attention(tp, torch.from_numpy(xs), tcfg, tq,
                                 torch.from_numpy(pos), cache=tc, key=tkey,
                                 attn_pols=(thead,) * tcfg.n_heads)
        np.testing.assert_allclose(yt.numpy(), np.asarray(yj), atol=1e-4)
        assert tc["idx"] == int(jc["idx"])
    # training: no cache, positions from 0
    yj, _ = jattn.attention(jp, jnp.asarray(x), cfg, jq, jnp.arange(7),
                            key=key, attn_pols=(jhead,) * cfg.n_heads)
    yt, _ = tattn.attention(tp, torch.from_numpy(x), tcfg, tq,
                            torch.arange(7), key=tkey,
                            attn_pols=(thead,) * tcfg.n_heads)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), atol=1e-4)


def test_per_row_cache_raises_the_reference_error():
    tcfg = tcfgs.get_smoke("qwen3-8b").model
    cache = tattn.init_cache(2, 8, tcfg, device="cpu", per_row_idx=True)
    with pytest.raises(ValueError, match="per-slot ragged caches"):
        tattn.attention({}, torch.zeros((2, 1, tcfg.d_model)), tcfg,
                        TDPolicy(mode="quant"), torch.zeros((2, 1)),
                        cache=cache, attn_pols=(TDPolicy(mode="quant"),))


def test_smoke_serve_td_attn_quant_gives_reference_tokens(capsys):
    """``serve --td-attn quant`` (random init from each package's own
    seed is not shared, so both run the reference's converted weights
    through their steps) and the CLI itself."""
    from repro.configs.base import ShapeCfg as JShape
    from repro.launch import steps as jsteps
    from repro.models import get_api as jget_api
    from repro.tdsim.policy import quant_policy as jquant
    from repro_torch.configs.base import ShapeCfg as TShape
    from repro_torch.launch import steps as tsteps

    from repro.configs.base import TrainCfg as JTrain
    from repro_torch.configs.base import TrainCfg as TTrain
    ja = jcfgs.get_smoke("qwen3-8b").replace(
        td=JTD(mode="quant"), td_attn=JTD(mode="quant"),
        train=JTrain(compute_dtype="float32"))
    ta = tcfgs.get_smoke("qwen3-8b").replace(
        td=TTD(mode="quant"), td_attn=TTD(mode="quant"),
        train=TTrain(compute_dtype="float32"))
    cfg = ja.model
    jp = jget_api(cfg)["init"](jax.random.key(0), cfg, jquant())
    tp = convert.params_from_jax(jax.device_get(jp), cfg, device="cpu")
    toks = tserve.prompts(1, 2, 8, cfg.vocab)
    jpre = jsteps.build_prefill_step(ja, JShape("s", 14, 2, "decode"))
    jsrv = jsteps.build_serve_step(ja, JShape("s", 14, 2, "decode"))
    tpre = tsteps.build_prefill_step(ta, TShape("s", 14, 2, "decode"),
                                     device="cpu")
    tsrv = tsteps.build_serve_step(ta, TShape("s", 14, 2, "decode"),
                                   device="cpu")
    jl, js = jpre(jp, {"tokens": jnp.asarray(toks)})
    tl, ts = tpre(tp, {"tokens": torch.from_numpy(toks)})
    jt = jnp.argmax(jl[:, -1], -1).astype(jnp.int32)[:, None]
    tt = torch.argmax(tl[:, -1], -1).to(torch.int32)[:, None]
    jo, to = [np.asarray(jt)], [tt.numpy()]
    for _ in range(5):
        jt, js = jsrv(jp, jt, js)
        tt, ts = tsrv(tp, tt, ts)
        jo.append(np.asarray(jt))
        to.append(tt.numpy())
    np.testing.assert_array_equal(np.concatenate(to, 1),
                                  np.concatenate(jo, 1))
    np.testing.assert_array_equal(tl.float().numpy(), np.asarray(jl))
    ids = tserve.main(["--smoke", "--device", "cpu", "--td", "td",
                       "--td-attn", "quant", "--batch", "1",
                       "--prompt-len", "4", "--gen", "2"])
    assert ids.shape == (1, 2)
    assert "[serve] prefill" in capsys.readouterr().out


def _sigma0(pol):
    """``pol`` (a TDPolicy or a NetworkPolicy of either package) with
    every sigma_chain set to 0."""
    if hasattr(pol, "layers"):
        return dataclasses.replace(
            pol, layers=tuple(map(_sigma0, pol.layers)), top=_sigma0(pol.top),
            attn=None if pol.attn is None else tuple(map(_sigma0, pol.attn)))
    return dataclasses.replace(pol, sigma_chain=0.0)


def test_moe_smoke_serve_td_attn_td_gives_reference_tokens(monkeypatch):
    """granite-moe-1b-a400m's smoke model served with ``--td quant
    --td-attn td`` (the experts and denses quantized, attention through
    the td_vmm lanes): the head policies solved by each package, then set
    to sigma 0 (the noise's Box-Muller is not bit-reproducible across
    backends), the reference's converted weights through both packages'
    prefill and serve steps (a 4-token prefill and 2 decode steps), the
    reference op by op (see the module docstring; its td_vmm through the
    plain oracle, which that needs): equal tokens, and the prefill's
    logits within 1e-4 of their scale."""
    from repro.configs.base import ShapeCfg as JShape
    from repro.configs.base import TrainCfg as JTrain
    from repro.launch import steps as jsteps
    from repro.models import get_api as jget_api
    from repro.tdsim.policy import quant_policy as jquant
    from repro_torch.configs.base import ShapeCfg as TShape
    from repro_torch.configs.base import TrainCfg as TTrain
    from repro_torch.launch import steps as tsteps

    from repro.tdsim import td_linear as jlin
    name = "granite-moe-1b-a400m"
    monkeypatch.setattr(jlin.td_ops, "td_vmm_seeded", _oracle_td_vmm)
    ja = jcfgs.get_smoke(name)
    ja = ja.replace(td=JTD(mode="quant"), td_attn=JTD(mode="td",
                                                   n_chain=ja.model.hd),
                    train=JTrain(compute_dtype="float32"))
    ta = tcfgs.get_smoke(name)
    ta = ta.replace(td=TTD(mode="quant"), td_attn=TTD(mode="td",
                                                   n_chain=ta.model.hd),
                    train=TTrain(compute_dtype="float32"))
    # solved once here (the reference's solve is compiled, not op by op)
    jpol = _sigma0(jcommon.resolve_arch_policy(ja))
    tpol = _sigma0(tcommon.resolve_arch_policy(ta, device="cpu"))
    assert tpol.attn is not None and len(tpol.attn) == ta.model.n_heads
    monkeypatch.setattr(jcommon, "resolve_arch_policy", lambda a: jpol)
    monkeypatch.setattr(tcommon, "resolve_arch_policy",
                        lambda a, device=None: tpol)
    cfg = ja.model
    jp = jget_api(cfg)["init"](jax.random.key(0), cfg, jquant())
    tp = convert.params_from_jax(jax.device_get(jp), cfg, device="cpu")
    toks = tserve.prompts(1, 2, 4, cfg.vocab)
    shape_j, shape_t = JShape("s", 7, 2, "decode"), TShape("s", 7, 2,
                                                        "decode")
    with jax.disable_jit():
        jpre = jsteps.build_prefill_step(ja, shape_j)
        jsrv = jsteps.build_serve_step(ja, shape_j)
        jl, js = jpre(jp, {"tokens": jnp.asarray(toks)})
        jt = jnp.argmax(jl[:, -1], -1).astype(jnp.int32)[:, None]
        jo = [np.asarray(jt)]
        for _ in range(2):
            jt, js = jsrv(jp, jt, js)
            jo.append(np.asarray(jt))
    tpre = tsteps.build_prefill_step(ta, shape_t, device="cpu")
    tsrv = tsteps.build_serve_step(ta, shape_t, device="cpu")
    tl, ts = tpre(tp, {"tokens": torch.from_numpy(toks)})
    tt = torch.argmax(tl[:, -1], -1).to(torch.int32)[:, None]
    to = [tt.numpy()]
    for _ in range(2):
        tt, ts = tsrv(tp, tt, ts)
        to.append(tt.numpy())
    np.testing.assert_array_equal(np.concatenate(to, 1),
                                  np.concatenate(jo, 1))
    jl = np.asarray(jl)
    np.testing.assert_allclose(tl.float().numpy(), jl, rtol=0,
                               atol=1e-4 * float(np.abs(jl).max()))


def test_smoke_train_step_td_attn_matches_reference(monkeypatch):
    """A train step of the qwen3-8b smoke model with ``--td-attn td``
    (noise on in the denses and in attention), the reference op by op."""
    ja, ta = archs("qwen3-8b", "td", "float32")
    ja = ja.replace(td_attn=JTD(mode="td", n_chain=ja.model.hd))
    ta = ta.replace(td_attn=TTD(mode="td", n_chain=ta.model.hd))
    out, jp, tp = run_both(ja, ta, 1, jit=False, monkeypatch=monkeypatch)
    assert np.all(np.isfinite(out["tl"]))
    np.testing.assert_allclose(out["tl"], out["jl"], rtol=1e-5)
    np.testing.assert_allclose(out["tg"], out["jg"], rtol=1e-4)
    assert_params_close(jp, tp, out["lr"], atol=1e-7, max_flip_share=1e-3)
    losses = ttrain.main(["--smoke", "--arch", "qwen3-8b", "--td", "td",
                          "--td-attn", "td", "--steps", "1", "--seq", "16",
                          "--batch", "4", "--device", "cpu"])
    assert len(losses) == 1 and np.all(np.isfinite(losses))


def test_scheduler_with_td_attn_raises_the_same_value_error(monkeypatch):
    argv = ["--smoke", "--td", "quant", "--td-attn", "quant", "--scheduler",
            "--streams", "2", "--capacity", "2", "--prompt-len", "4",
            "--gen", "2"]
    monkeypatch.setattr("sys.argv", ["serve"] + argv)
    with pytest.raises(ValueError) as jerr:
        jserve.main()
    with pytest.raises(ValueError) as terr:
        tserve.main(argv + ["--device", "cpu"])
    assert str(terr.value) == str(jerr.value)


def test_resolve_arch_policy_td_attn_heads():
    """Per-head policies: one a query head, n_chain clamped to the head
    dim, attached to a promoted NetworkPolicy; the non-decoder error."""
    from repro_torch.tdsim.policy import NetworkPolicy
    ta = tcfgs.get_smoke("granite-8b").replace(
        td_attn=TTD(mode="td", bits_a=8, bits_w=8, n_chain=576,
                    sigma_max=2.0))
    pol = tcommon.resolve_arch_policy(ta, device="cpu")
    assert isinstance(pol, NetworkPolicy) and pol.homogeneous
    assert len(pol.attn) == ta.model.n_heads
    assert all(p.n_chain == ta.model.hd and p.mode == "td"
               for p in pol.attn)
    want = jcommon.resolve_arch_policy(jcfgs.get_smoke("granite-8b").replace(
        td_attn=JTD(mode="td", bits_a=8, bits_w=8, n_chain=576,
                    sigma_max=2.0)))
    assert (pol.attn[0].redundancy, pol.attn[0].tdc_q) == \
        (want.attn[0].redundancy, want.attn[0].tdc_q)
    bad = ta.replace(model=ta.model.__class__(**{**ta.model.__dict__,
                                                 "family": "encdec"}))
    with pytest.raises(ValueError, match="decoder-family"):
        tcommon.resolve_arch_policy(bad, device="cpu")


def test_params_from_jax_default_to_cuda(monkeypatch):
    """Without a device the converted decoder parameters go to CUDA, and a
    host without it raises rather than falling back to the CPU."""
    from repro.models import get_api as jget_api
    from repro.tdsim.policy import quant_policy as jquant
    cfg = jcfgs.get_smoke("qwen3-8b").model
    tree = jax.device_get(jget_api(cfg)["init"](jax.random.key(0), cfg,
                                                jquant()))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        convert.params_from_jax(tree, cfg)
