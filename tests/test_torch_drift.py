"""Port parity of drift adaptation (`repro_torch.ft.drift`, the runtime
policy operands of `repro_torch.models.common`, the adaptive decode step
and `ContinuousBatchingEngine(adapt=True)`) against the reference
(`repro.ft.drift`, `repro.models.common`, `repro.launch.scheduler`).

* Drift statistics: `measure_p_x_one` with and without a mask, and on an
  all-zero mask, equals the reference within 1e-7 relative; the
  planeless `weight_bit_sparsity` equals the plain formula.
* `DriftEstimator`, `StagedRebuild`, `ResolverChain` and the explorer's
  `count_fallback` under 8 threads.
* Policies: `runtime_td_policy`, `td_policy_ops`, `td_layer_indices` and
  `replace_td_layers` agree with the reference; td_vmm reads a runtime
  policy's row of the operand tensor itself (bit-exact against the
  memoized operand, moved by an in-place write, no memo entry).
* The adaptive engine: the port's and the reference's engines serve the
  smoke qwen3-8b (float32 compute, the reference's parameters) under one
  trace, each with a resolver and a supply resolver that wrap the real
  solves and set sigma_chain to 0, and an initial policy at sigma 0, so
  the tokens carry no Box-Muller noise (not bit-reproducible across
  backends).  Equal tokens and swap_log steps, kinds and Vdds; ops within
  1e-6 relative, meter energies within 1e-4.  Staged rebuilds are waited
  out before each step in both, so their installs land at the same step.
  The port's scripted replay of its swap_log gives the same tokens, with
  the decode step built once and no new td_vmm operand.
"""
import torch_threads  # noqa: F401  (first: torch's threads under xdist)
import sys
import threading

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import repro.configs as jcfgs
from repro import ft as jft
from repro.configs.base import TDExecCfg as JTD
from repro.configs.base import TrainCfg as JTrain
from repro.launch import scheduler as jsched
from repro.models import common as jcommon
from repro.models import get_api as jget_api
from repro.tdsim import policy as jpolicy
import repro_torch.configs as tcfgs
from repro_torch import ft
from repro_torch.configs.base import TDExecCfg as TTD
from repro_torch.configs.base import TrainCfg as TTrain
from repro_torch.convert import params_from_jax
from repro_torch.core import explorer as texplorer
from repro_torch.ft import drift as tdrift
from repro_torch.kernels.td_vmm import ops as tops
from repro_torch.launch import scheduler as tsched
from repro_torch.launch import serve as tserve
from repro_torch.launch import steps as tsteps
from repro_torch.models import common as tcommon
from repro_torch.tdsim import policy as tpolicy
from repro_torch.tdsim import td_linear as tlin


# ---------------------------------------------------------------------------
# drift statistics
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("shape,bits,mask", [
    ((4, 16), 4, None), ((4, 16), 4, [1, 1, 0, 0]), ((3, 8), 4, [0, 0, 0]),
    ((5, 7, 3), 8, [0, 1, 0, 1, 1]), ((9, 33), 2, [1] * 9),
    ((2, 64), 4, [1, 0])])
def test_measure_p_x_one_matches_reference(shape, bits, mask):
    rng = np.random.default_rng(sum(shape) + bits)
    x = rng.normal(size=shape).astype(np.float32)
    m = None if mask is None else np.asarray(mask, np.float32)
    want = float(jft.measure_p_x_one(
        jnp.asarray(x), bits, None if m is None else jnp.asarray(m)))
    got = tdrift.measure_p_x_one(torch.from_numpy(x), bits,
                                 None if m is None else torch.from_numpy(m))
    assert got.dtype == torch.float32 and got.dim() == 0
    np.testing.assert_allclose(float(got), want, rtol=1e-7, atol=0)
    if mask is not None and not any(mask):
        assert float(got) == 0.5


@pytest.mark.parametrize("shape,bits,chunk", [
    ((32, 32), 4, 1 << 24), ((33, 17), 4, 37), ((7, 130), 8, 64),
    ((1000,), 3, 999)])
def test_weight_bit_sparsity_planeless_equals_plain(monkeypatch, shape,
                                                    bits, chunk):
    w = torch.from_numpy(np.random.default_rng(3).normal(
        size=shape).astype(np.float32))
    monkeypatch.setattr(tdrift, "_CHUNK", chunk)
    got = tdrift.weight_bit_sparsity(w, bits)
    plain = 1.0 - float(tdrift.measure_p_x_one(w, bits))
    np.testing.assert_allclose(got, plain, rtol=1e-6, atol=0)
    np.testing.assert_allclose(
        got, jft.weight_bit_sparsity(jnp.asarray(w.numpy()), bits),
        rtol=1e-6, atol=0)


@pytest.mark.parametrize("kw,samples", [
    (dict(anchor=0.5, threshold=0.2, warmup=1), [0.6, 0.4, 0.6 + 1e-9]),
    (dict(anchor=0.5, threshold=0.2, warmup=3), [0.1] * 4),
    (dict(anchor=0.5, threshold=0.2, warmup=4), [0.05] * 5),
    (dict(anchor=0.5, threshold=0.2, warmup=2), [0.5] * 20),
    (dict(anchor=0.0, threshold=0.2, warmup=1), [0.0] * 5 + [1e-6]),
    (dict(anchor=0.5, alpha=0.5, threshold=0.2, warmup=3),
     [0.52] * 6 + [0.1] * 6)])
def test_drift_estimator_matches_reference(kw, samples):
    t, j = ft.DriftEstimator(**kw), jft.DriftEstimator(**kw)
    fired = [(t.update(v), j.update(v)) for v in samples]
    assert all(a == b for a, b in fired), fired
    assert (t.value, t.samples, t.excursions) == \
        (j.value, j.samples, j.excursions)
    t.rearm(0.1)
    j.rearm(0.1)
    assert [t.update(0.9) for _ in range(3)] == \
        [j.update(0.9) for _ in range(3)]


def test_staged_rebuild_and_resolver_chain():
    h = ft.StagedRebuild(lambda: {"ok": 1})
    assert h.wait(5.0) == {"ok": 1} and h.done and h.poll() == {"ok": 1}
    h = ft.StagedRebuild(lambda: (_ for _ in ()).throw(ValueError("died")))
    h._thread.join(5.0)
    with pytest.raises(RuntimeError, match="died") as ei:
        h.poll()
    assert isinstance(ei.value.__cause__, ValueError)
    assert h.poll() is None                  # raised exactly once
    ev = threading.Event()
    h = ft.StagedRebuild(ev.wait)
    assert h.poll() is None
    with pytest.raises(TimeoutError):
        h.wait(0.01)
    ev.set()
    assert h.wait(5.0)

    calls = []

    def dead(x):
        raise TimeoutError("explorer dark")

    chain = ft.ResolverChain(dead, lambda x: calls.append(
        threading.current_thread().name) or ["local", x])
    h = ft.StagedRebuild(lambda: chain(1), name="staged-test")
    assert h.wait(5.0) == ["local", 1] and calls == ["staged-test"]
    assert chain.fallbacks == 1 and chain.degraded
    chain.primary = lambda x: ["remote", x]
    assert chain(2) == ["remote", 2] and not chain.degraded

    def data_error(x):
        raise ValueError("bad spec")         # not an outage: propagates

    chain = ft.ResolverChain(data_error, lambda x: "local")
    with pytest.raises(ValueError):
        chain(1)
    assert chain.fallbacks == 0


def test_count_fallback_is_thread_safe():
    svc = texplorer.ExplorerService(device="cpu")
    n, per = 8, 1000

    def spin():
        for _ in range(per):
            svc.count_fallback()

    ts = [threading.Thread(target=spin) for _ in range(n)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)       # switch threads as often as it can
    try:
        for t in ts:
            t.start()
        for t in ts:
            t.join(30.0)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in ts)
    assert svc.stats.fallback_resolves == n * per == 8000


# ---------------------------------------------------------------------------
# runtime policy operands
# ---------------------------------------------------------------------------
def _policies(mod):
    td = mod.TDPolicy(mode="td", n_chain=64, redundancy=3,
                      sigma_chain=0.75, tdc_q=2, sigma_max=2.0)
    return mod.NetworkPolicy(layers=(td, mod.quant_policy(),
                                     td.replace(sigma_chain=1.5, tdc_q=3)),
                             top=td.replace(tdc_q=5)), td


def _fields(p) -> dict:
    return {f: (float(v) if f in ("sigma_chain", "tdc_q") else v)
            for f, v in vars(p).items() if f != "techlib"}


def test_runtime_policy_helpers_match_reference():
    (tnet, ttd), (jnet, jtd) = _policies(tpolicy), _policies(jpolicy)
    for t, j in ((tnet, jnet), (ttd, jtd)):
        ops = tcommon.td_policy_ops(t)
        np.testing.assert_array_equal(ops.numpy(),
                                      np.asarray(jcommon.td_policy_ops(j)))
        assert tcommon.td_layer_indices(t) == jcommon.td_layer_indices(j)
        new = (ops + 1.0) * 2.0
        rt = tcommon.runtime_td_policy(t, new)
        rj = jcommon.runtime_td_policy(j, jnp.asarray(new.numpy()))
        for a, b in zip(rt.layers if t is tnet else [rt],
                        rj.layers if t is tnet else [rj]):
            assert _fields(a) == _fields(b)
        if t is tnet:
            assert rt.top == t.top and rj.top == j.top
            # the bound values are views of the operand tensor
            assert rt.layers[2].sigma_chain.data_ptr() == \
                new[2].data_ptr()
        solved = [p.replace(redundancy=9) for p in
                  (rt.layers if t is tnet else [rt])
                  if p.mode == "td"]
        jsolved = [p.replace(redundancy=9) for p in
                   (rj.layers if t is tnet else [rj]) if p.mode == "td"]
        a = tcommon.replace_td_layers(t, solved)
        b = jcommon.replace_td_layers(j, jsolved)
        for x, y in zip(a.layers if t is tnet else [a],
                        b.layers if t is tnet else [b]):
            assert _fields(x) == _fields(y)
        with pytest.raises(ValueError, match="solved td layers"):
            tcommon.replace_td_layers(t, solved[:-1] + solved + solved)


def test_td_vmm_reads_the_operand_row_in_place():
    g = torch.Generator().manual_seed(0)
    x = torch.randint(-8, 8, (5, 100), generator=g, dtype=torch.int32)
    w = torch.randint(-8, 8, (100, 24), generator=g, dtype=torch.int32)
    base = tpolicy.TDPolicy(mode="td", n_chain=48)
    ops = torch.tensor([[0.0, 1.0], [1.25, 3.0]])
    rt = tcommon.runtime_td_policy(
        tpolicy.NetworkPolicy(layers=(base, base)), ops)
    n0 = len(tops._params)
    got = [tops.td_vmm_seeded(x, w, rt.layers[i], 77) for i in (0, 1)]
    assert len(tops._params) == n0
    assert tops.policy_params(rt.layers[1], x.device).data_ptr() == \
        ops[1].data_ptr()
    for i in (0, 1):
        want = tops.td_vmm_seeded(x, w, base.replace(
            sigma_chain=float(ops[i, 0]), tdc_q=float(ops[i, 1])), 77)
        assert torch.equal(got[i], want)
    assert not torch.equal(got[0], got[1])
    ops[1].copy_(torch.tensor([0.0, 1.0]))       # a swap, in place
    assert torch.equal(tops.td_vmm_seeded(x, w, rt.layers[1], 77), got[0])
    # the oracle takes the operands the same way: sigma 0 adds exactly 0,
    # q is clamped to at least 1
    eps = torch.randn((4, 5, 3, 24), generator=g)
    for sigma, q in ((0.0, 1.0), (0.5, 0.25), (2.0, 4.0)):
        ops[0].copy_(torch.tensor([sigma, q]))
        want = tlin.td_matmul_int(x, w, base.replace(
            sigma_chain=sigma, tdc_q=max(q, 1.0)), eps)
        assert torch.equal(tlin.td_matmul_int(x, w, rt.layers[0], eps), want)


@pytest.mark.parametrize("case", ["two tensors", "strided row", "f64 row",
                                  "float q"])
def test_td_vmm_refuses_operands_that_are_not_one_row(case):
    """A tensor (sigma, q) that is not one f32 row's two adjacent elements
    raises instead of being copied at every launch."""
    x = torch.ones((2, 8), dtype=torch.int32)
    w = torch.ones((8, 3), dtype=torch.int32)
    base = tpolicy.TDPolicy(mode="td", n_chain=8)
    ops = torch.tensor([[0.5, 2.0], [1.0, 1.0]])
    sigma, q = {"two tensors": (torch.tensor(0.5), torch.tensor(2.0)),
                "strided row": (ops[0, 0], ops[1, 0]),
                "f64 row": tuple(ops[0].double()),
                "float q": (ops[0, 0], 2.0)}[case]
    with pytest.raises(ValueError, match="one f32 row"):
        tops.td_vmm_seeded(x, w, base.replace(sigma_chain=sigma, tdc_q=q), 7)


# ---------------------------------------------------------------------------
# the adaptive engine against the reference's
# ---------------------------------------------------------------------------
def _trace(mod):
    return mod.TrafficTrace([
        mod.TraceSegment(steps=4, activity=1.0),
        mod.TraceSegment(steps=60, activity=0.25, sparsity=0.85, load=0.5),
    ], seed=1)


def _reqs(mod, n=3, plen=4, gen=20):
    return [mod.Request(rid=i, prompt=np.arange(1, 1 + plen,
                                                dtype=np.int32),
                        max_new_tokens=gen, arrival_s=0.0)
            for i in range(n)]


def _run(eng, mod, fmod):
    def settle(_step):     # land every staged rebuild at the next boundary
        if eng._staged is not None:
            eng._staged.wait(60.0)

    out = eng.run(_reqs(mod), retry_policy=fmod.RetryPolicy(backoff_s=0.0),
                  trace=_trace(fmod), inject=settle)
    return out, {rid: list(r.generated) for rid, r in eng.done.items()}


@pytest.fixture(scope="module")
def engines():
    cfg = jcfgs.get_smoke("qwen3-8b").model
    jp = jget_api(cfg)["init"](jax.random.key(0), cfg,
                               jpolicy.quant_policy())
    tp = params_from_jax(jax.device_get(jp), cfg, device="cpu")
    ja = jcfgs.get_smoke("qwen3-8b").replace(
        td=JTD(mode="td", sigma_max=2.0),
        train=JTrain(compute_dtype="float32"))
    ta = tcfgs.get_smoke("qwen3-8b").replace(
        td=TTD(mode="td", sigma_max=2.0),
        train=TTrain(compute_dtype="float32"))
    kw = dict(capacity=2, s_cache=30, kv_block=8, adapt=True,
              drift_threshold=0.1)
    mp = pytest.MonkeyPatch()
    jorig, torig = jcommon.resolve_arch_policy, tcommon.resolve_arch_policy
    mp.setattr(jcommon, "resolve_arch_policy",
               lambda a: jorig(a).replace(sigma_chain=0.0))
    mp.setattr(tcommon, "resolve_arch_policy",
               lambda a, device=None: torig(a, device).replace(
                   sigma_chain=0.0))
    builds = []
    tbuild = tsteps.build_adaptive_serve_step
    mp.setattr(tsteps, "build_adaptive_serve_step",
               lambda *a, **k: builds.append(1) or tbuild(*a, **k))
    try:
        jeng = jsched.ContinuousBatchingEngine(
            ja, params=jp, **kw,
            resolver=lambda s: [p.replace(sigma_chain=0.0)
                                for p in jpolicy.solve_td_policies(s)],
            supply_resolver=lambda s: [
                p.replace(sigma_chain=0.0)
                for p in jpolicy.solve_td_policies_over_vdd(s)])
        jeng.warmup()
        jout, jtok = _run(jeng, jsched, jft)

        def teng_of(**extra):
            return tsched.ContinuousBatchingEngine(
                ta, params=tp, device="cpu", **kw, **extra,
                resolver=lambda s: [
                    p.replace(sigma_chain=0.0)
                    for p in tpolicy.solve_td_policies(s, "cpu")],
                supply_resolver=lambda s: [
                    p.replace(sigma_chain=0.0)
                    for p in tpolicy.solve_td_policies_over_vdd(
                        s, device="cpu")])

        teng = teng_of()
        teng.warmup()
        n0 = len(tops._params)
        tout, ttok = _run(teng, tsched, ft)
        memo_growth = len(tops._params) - n0
        reng = teng_of(scripted_swaps=teng.swap_log)
        rout, rtok = _run(reng, tsched, ft)
        n_builds = len(builds)
    finally:
        mp.undo()
    return dict(jeng=jeng, jout=jout, jtok=jtok, teng=teng, tout=tout,
                ttok=ttok, rout=rout, rtok=rtok, memo_growth=memo_growth,
                n_builds=n_builds)


def test_adaptive_engine_matches_reference(engines):
    e = engines
    jout, tout = e["jout"], e["tout"]
    assert tout["requests"] == jout["requests"] == 3          # zero lost
    assert e["ttok"] == e["jtok"]
    assert tout["adaptations"] == jout["adaptations"] >= 1
    assert tout["supply_spans"] == jout["supply_spans"] >= 1
    assert tout["swap_log"] == jout["swap_log"]                # step/kind/vdds
    for t, j in zip(e["teng"].swap_log, e["jeng"].swap_log):
        np.testing.assert_allclose(t["ops"], np.asarray(j["ops"]),
                                   rtol=1e-6, atol=0)
    np.testing.assert_allclose(e["teng"]._ops.numpy(),
                               np.asarray(e["jeng"]._ops), rtol=1e-6)
    for k in ("energy_j_total", "static_worst_energy_j", "j_per_token"):
        np.testing.assert_allclose(tout[k], jout[k], rtol=1e-4)
    np.testing.assert_allclose(e["teng"].meter.rate_history,
                               e["jeng"].meter.rate_history, rtol=1e-4)
    assert tout["meter_policy_swaps"] == jout["meter_policy_swaps"]
    np.testing.assert_allclose(tout["p_x_one_measured"],
                               jout["p_x_one_measured"], rtol=1e-5)
    assert tout["energy_j_total"] < tout["static_worst_energy_j"]
    assert tout["trace"] == jout["trace"]


def test_scripted_replay_equals_live_run_without_rebuild(engines):
    e = engines
    assert e["rtok"] == e["ttok"]
    assert e["rout"]["adaptations"] == 0                      # detection off
    assert e["n_builds"] == 2          # one decode step per engine
    assert e["memo_growth"] == 0


def test_serve_cli_adapt_and_trace(tmp_path, capsys):
    t = tserve.parse_trace("11:64:4")
    assert t.seed == 11 and t.total_steps == 64 and len(t.segments) == 4
    assert t.to_json() == jft.TrafficTrace.generate(
        11, 64, n_segments=4).to_json()
    p = tmp_path / "trace.json"
    t.save(str(p))
    assert tserve.parse_trace(f"@{p}") == t
    with pytest.raises(ValueError):
        tserve.parse_trace("garbage")
    out = tserve.main(["--smoke", "--scheduler", "--device", "cpu", "--td",
                       "td", "--streams", "3", "--capacity", "2",
                       "--prompt-len", "4", "--gen", "6", "--trace",
                       f"@{p}"])
    assert out["requests"] == 3 and out["trace"]["seed"] == 11
    assert "p_x_one_measured" in out
    text = capsys.readouterr().out
    assert "[serve/sched] drift:" in text and "[serve/sched] trace:" in text
