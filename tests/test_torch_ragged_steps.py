"""Port parity of the continuous-batching engine's steps and planning: the
ragged prefill, the insert into a per-row cache and one per-row decode
step of the qwen3-8b smoke model, each package's own, on the reference's
parameters (`api["init"]`, converted by `params_from_jax`) and the same
numpy prompts; then `plan_kv_cache` and the serve CLI's scheduler mode.

Float32 compute, the reference under `jax.jit`.  Tolerances: next tokens
identical; logits within 1e-4 (quant, and td at sigma = 0 with the policy
built by hand); td at the solved exact-regime policy (noise on) tokens
identical only, as in `test_torch_serve.py`.  The bf16 caches after the
insert, and after the decode step, are bit-equal, and the fill-index
vectors equal.  The batch has a free row whose index has passed the cache
length: its write lands at the last position (the reference's clamp) and
its RoPE position stays unclamped.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import repro.configs as jcfgs
from repro.configs.base import TDExecCfg as JTD
from repro.configs.base import TrainCfg as JTrain
from repro.launch import steps as jsteps
from repro.models import get_api as jget_api
from repro.models import transformer as jtransformer
from repro.roofline import model as jroof
from repro.tdsim.policy import TDPolicy as JPolicy
from repro.tdsim.policy import quant_policy as jquant
import repro_torch.configs as tcfgs
from repro_torch.configs.base import TDExecCfg as TTD
from repro_torch.configs.base import TrainCfg as TTrain
from repro_torch.convert import params_from_jax
from repro_torch.launch import serve as tserve
from repro_torch.launch import steps as tsteps
from repro_torch.models import attention as tattn
from repro_torch.models import common as tcommon
from repro_torch.models import get_api as tget_api
from repro_torch.models import transformer as ttransformer
from repro_torch.roofline import model as troof
from repro_torch.tdsim.policy import TDPolicy as TPolicy

CAP, S, PAD = 3, 16, 12          # slots, decode cache, prefill bucket
LENS = {0: 5, 2: 9}              # slot -> prompt length; slot 1 stays free
FREE_IDX = S + 3                 # the free slot's index, past S


@pytest.fixture(scope="module")
def params():
    cfg = jcfgs.get_smoke("qwen3-8b").model
    jp = jget_api(cfg)["init"](jax.random.key(0), cfg, jquant())
    return jp, params_from_jax(jax.device_get(jp), cfg, device="cpu")


def _setup(mode, monkeypatch):
    """(reference arch, port arch, reference policy, port policy)."""
    td = "td" if mode == "td0" else mode
    ja = jcfgs.get_smoke("qwen3-8b").replace(
        td=JTD(mode=td, n_chain=64), train=JTrain(compute_dtype="float32"))
    ta = tcfgs.get_smoke("qwen3-8b").replace(
        td=TTD(mode=td, n_chain=64), train=TTrain(compute_dtype="float32"))
    if mode == "td0":
        # the steps resolve their policy inside: sigma = 0 by hand
        monkeypatch.setattr(jsteps.common, "resolve_arch_policy",
                            lambda a: JPolicy(mode="td", n_chain=64))
        monkeypatch.setattr(tsteps.common, "resolve_arch_policy",
                            lambda a, device=None: TPolicy(mode="td",
                                                            n_chain=64))
    return (ja, ta, jsteps.common.resolve_arch_policy(ja),
            tsteps.common.resolve_arch_policy(ta, device="cpu"))


def _bits(x) -> np.ndarray:
    """The bit patterns of a bf16 array or tensor, as uint16."""
    if isinstance(x, torch.Tensor):
        return x.view(torch.int16).numpy().view(np.uint16)
    return np.asarray(x).view(np.uint16)


def _assert_caches_equal(jstate, tstate):
    for jc, tc in zip(jstate["layers"], tstate["layers"]):
        for name in ("k", "v"):
            np.testing.assert_array_equal(_bits(tc[name]), _bits(jc[name]))
        np.testing.assert_array_equal(tc["idx"].numpy(),
                                      np.asarray(jc["idx"]))


@pytest.mark.parametrize("mode", ["quant", "td0", "td"])
def test_ragged_prefill_insert_and_per_row_decode(params, monkeypatch, mode):
    ja, ta, jpol, tpol = _setup(mode, monkeypatch)
    cfg_j, cfg_t = ja.model, ta.model
    jp, tp = params
    exact = mode != "td"
    rng = np.random.default_rng(7)

    j_pre = jax.jit(jsteps.build_ragged_prefill_step(ja, PAD))
    j_logits = jax.jit(lambda p, t, n: jget_api(cfg_j)["prefill"](
        p, {"tokens": t}, cfg_j, jpol, s_cache=PAD, true_len=n)[0])
    j_ins = jax.jit(jsteps.build_insert_step())
    j_dec = jax.jit(lambda p, t, s: jget_api(cfg_j)["decode_step"](
        p, t, s, cfg_j, jpol))
    t_pre = tsteps.build_ragged_prefill_step(ta, PAD, device="cpu")
    t_ins = tsteps.build_insert_step()
    t_api = tget_api(cfg_t)

    jstate = {"layers": jtransformer.init_caches(CAP, S, cfg_j, jnp.bfloat16,
                                                 pol=jpol, per_row_idx=True),
              "enc_out": None}
    tstate = {"layers": ttransformer.init_caches(CAP, S, cfg_t, device="cpu",
                                                 per_row_idx=True),
              "enc_out": None}
    jtok = np.zeros((CAP, 1), np.int32)
    ttok = torch.zeros((CAP, 1), dtype=torch.int32)
    for slot, n in LENS.items():
        padded = np.zeros((1, PAD), np.int32)
        padded[0, :n] = rng.integers(3, cfg_j.vocab, size=n)
        jt, jps = j_pre(jp, jnp.asarray(padded), jnp.asarray(n, jnp.int32))
        tt, tps = t_pre(tp, torch.from_numpy(padded), n)
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
        assert tps["layers"][0]["idx"] == PAD
        jl = j_logits(jp, jnp.asarray(padded), jnp.asarray(n, jnp.int32))
        tl, _ = t_api["prefill"](tcommon.cast_tree(tp, torch.float32),
                                 {"tokens": torch.from_numpy(padded)},
                                 cfg_t, tpol, s_cache=PAD, true_len=n)
        assert tl.shape == (1, 1, cfg_t.vocab)
        if exact:
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                                       atol=1e-4)
        jstate = j_ins(jstate, jps, jnp.asarray(slot, jnp.int32),
                       jnp.asarray(n, jnp.int32))
        assert t_ins(tstate, tps, slot, n) is tstate
        jtok[slot] = np.asarray(jt)[0]
        ttok[slot] = tt[0]
    _assert_caches_equal(jstate, tstate)
    assert tstate["layers"][0]["idx"].tolist() == [5, 0, 9]

    # slot 1 is free and has decoded past the end of its cache
    jstate["layers"] = [dict(c, idx=c["idx"].at[1].set(FREE_IDX))
                        for c in jstate["layers"]]
    for c in tstate["layers"]:
        c["idx"][1] = FREE_IDX
    jl, jstate = j_dec(jp, jnp.asarray(jtok), jstate)
    tl, tstate = t_api["decode_step"](tp, ttok, tstate, cfg_t, tpol)
    np.testing.assert_array_equal(
        torch.argmax(tl, -1).numpy(), np.asarray(jnp.argmax(jl, -1)))
    if exact:
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                                   atol=1e-4)
    _assert_caches_equal(jstate, tstate)
    assert tstate["layers"][1]["idx"].tolist() == [6, FREE_IDX + 1, 10]


def test_per_row_cache_rejects_prefill_and_td_attention():
    cfg = tcfgs.get_smoke("qwen3-8b").model
    lp = ttransformer.init_params(0, cfg, tcommon.resolve_policy(TTD()),
                                  device="cpu")["layers"][0]["attn"]
    cache = tattn.init_cache(2, 8, cfg, device="cpu", per_row_idx=True)
    assert cache["idx"].dtype == torch.int32 and cache["idx"].shape == (2,)
    x = torch.zeros((2, 3, cfg.d_model))
    with pytest.raises(ValueError, match="single-token"):
        tattn.attention(lp, x, cfg, TPolicy(), torch.arange(3), cache=cache)
    with pytest.raises(ValueError, match="per-slot ragged caches"):
        tattn.attention(lp, x[:, :1], cfg, TPolicy(),
                        torch.zeros((2, 1), dtype=torch.int32), cache=cache,
                        attn_pols=(TPolicy(),) * cfg.n_heads)


@pytest.mark.parametrize("arch,capacity,s_cache,block,hbm", [
    ("qwen3-8b", 8, 144, 64, None),
    ("qwen3-8b", 600, 144, 64, 16e9),     # capped by the budget
    ("granite-8b", 4, 1000, 128, 80e9),
    ("smoke", 3, 16, 8, 80e9),
])
def test_plan_kv_cache_matches_reference(arch, capacity, s_cache, block,
                                         hbm):
    if arch == "smoke":
        jc, tc = (jcfgs.get_smoke("qwen3-8b").model,
                  tcfgs.get_smoke("qwen3-8b").model)
    else:
        jc, tc = jcfgs.get(arch).model, tcfgs.get(arch).model
    kw = dict(block=block, hbm_bytes=troof.H100_HBM_BYTES if hbm is None
              else hbm)
    want = jroof.plan_kv_cache(jc, capacity, s_cache, **kw)
    got = troof.plan_kv_cache(tc, capacity, s_cache, **kw)
    assert {f: getattr(got, f) for f in want.__dataclass_fields__} == \
        {f: getattr(want, f) for f in want.__dataclass_fields__}
    assert got.fits == want.fits
    if hbm is None:       # the port's default budget is the H100's 80 GB
        assert troof.plan_kv_cache(tc, capacity, s_cache, block=block) == got
        assert got.s_cache == 192 and got.fits
    assert troof.device_hbm_bytes("cpu") == troof.H100_HBM_BYTES


def test_serve_cli_scheduler_on_cpu(capsys):
    out = tserve.main(["--smoke", "--scheduler", "--device", "cpu", "--td",
                       "quant", "--streams", "4", "--capacity", "2",
                       "--prompt-len", "6", "--gen", "4"])
    assert out["requests"] == 4 and out["steps"] > 0
    assert all(1 <= r["new_tokens"] <= 4 for r in out["per_request"])
    text = capsys.readouterr().out
    assert "[serve/sched] 4 requests" in text and "capacity 2" in text
    want = tserve.synthetic_requests(4, 6, 4, 128, seed=1)
    assert sum(r.max_new_tokens for r in want) == out["new_tokens"]
    for flag in (["--adapt"], ["--trace", "1:10"]):
        out = tserve.main(["--smoke", "--scheduler", "--device", "cpu",
                           "--td", "quant", "--streams", "2", "--capacity",
                           "2", "--prompt-len", "4", "--gen", "3", *flag])
        assert out["requests"] == 2 and "p_x_one_measured" in out
    assert "[serve/sched] trace: seed=1" in capsys.readouterr().out


def test_synthetic_requests_match_reference():
    from repro.launch import serve as jserve
    for seed in (1, 5):
        a = jserve.synthetic_requests(8, 16, 8, vocab=1000, seed=seed)
        b = tserve.synthetic_requests(8, 16, 8, vocab=1000, seed=seed)
        for x, y in zip(a, b):
            assert x.rid == y.rid and x.max_new_tokens == y.max_new_tokens
            np.testing.assert_array_equal(x.prompt, y.prompt)
