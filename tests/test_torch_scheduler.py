"""Port parity of the continuous-batching serve engine
(`repro_torch.launch.scheduler`) on the qwen3-8b smoke model, with the
reference's parameters (`api["init"]`, converted by `params_from_jax`) and
numpy-seeded ragged requests.

* Against the JAX engine (`repro.launch.scheduler`) at capacity 3, float32
  compute, in quant mode, td at sigma = 0 (the policy built by hand) and
  td at the solved exact-regime policy (noise on): each request's
  generated tokens, `steps_run` and the completion order are equal, and
  the energy meter's per-request and total J/token within rtol 1e-4.
  bfloat16 is left out: the JAX engine jits its steps, and XLA's CPU jit
  drops bf16 roundings the port keeps (ROADMAP §3).
* The JAX engine's own gates (`tests/test_serving.py`), for the port, in
  quant mode at the smoke model's default bfloat16 compute, as that file
  runs them: FIFO admission, slot recycling in fewer steps than the
  lockstep baseline, ragged serving equal to the port's sequential b = 1
  path token for token, preemption drain and re-admission with zero lost
  requests and identical outputs, and the overflow rejection.  (In
  float32 the sequential path's last token of request 2 differs from the
  engine's, in the reference as in the port: a near tie that the batch's
  summation order decides.  The engines agree with each other there.)
"""
import torch_threads  # noqa: F401  (first: torch's threads under xdist)
import numpy as np
import pytest
import torch

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
from repro_torch import ft
from repro_torch.configs.base import ShapeCfg as TShape
from repro_torch.configs.base import TDExecCfg as TTD
from repro_torch.configs.base import TrainCfg as TTrain
from repro_torch.convert import params_from_jax
from repro_torch.launch import scheduler as tsched
from repro_torch.launch import serve as tserve
from repro_torch.launch import steps as tsteps
from repro_torch.models import common as tcommon
from repro_torch.tdsim.policy import TDPolicy as TPolicy

S_CACHE = 16
# (prompt length, new tokens): more requests than slots, finishing at
# different steps, so slots are recycled mid-run
LENS = [(3, 5), (7, 4), (5, 6), (4, 2), (6, 5), (2, 3)]


@pytest.fixture(scope="module")
def params():
    cfg = jcfgs.get_smoke("qwen3-8b").model
    jp = jget_api(cfg)["init"](jax.random.key(0), cfg, jquant())
    return jp, params_from_jax(jax.device_get(jp), cfg, device="cpu")


def _archs(mode, dtype="float32"):
    td = "td" if mode == "td0" else mode
    ja = jcfgs.get_smoke("qwen3-8b").replace(
        td=JTD(mode=td, n_chain=64), train=JTrain(compute_dtype=dtype))
    ta = tcfgs.get_smoke("qwen3-8b").replace(
        td=TTD(mode=td, n_chain=64), train=TTrain(compute_dtype=dtype))
    return ja, ta


def _reqs(mod, lens):
    rng = np.random.default_rng(11)
    return [mod.Request(rid=i,
                        prompt=rng.integers(3, 50, size=p).astype(np.int32),
                        max_new_tokens=g)
            for i, (p, g) in enumerate(lens)]


def _port_engine(params, capacity=3, continuous=True):
    """The port's engine in quant mode at the smoke model's default
    (bfloat16) compute, as `tests/test_serving.py` runs the reference's."""
    return tsched.ContinuousBatchingEngine(
        _archs("quant", "bfloat16")[1], capacity=capacity, s_cache=S_CACHE,
        params=params[1], kv_block=8, continuous=continuous, device="cpu")


@pytest.mark.parametrize("mode", ["quant", "td0", "td"])
def test_engine_matches_reference_engine(params, monkeypatch, mode):
    ja, ta = _archs(mode)
    if mode == "td0":
        # the engines and their steps resolve the policy inside
        monkeypatch.setattr(jcommon, "resolve_arch_policy",
                            lambda a: JPolicy(mode="td", n_chain=64))
        monkeypatch.setattr(tcommon, "resolve_arch_policy",
                            lambda a, device=None: TPolicy(mode="td",
                                                            n_chain=64))
    jeng = jsched.ContinuousBatchingEngine(ja, capacity=3, s_cache=S_CACHE,
                                           params=params[0], kv_block=8)
    teng = tsched.ContinuousBatchingEngine(ta, capacity=3, s_cache=S_CACHE,
                                           params=params[1], kv_block=8,
                                           device="cpu")
    assert (teng.capacity, teng.s_cache, teng.prompt_pad) == \
        (jeng.capacity, jeng.s_cache, jeng.prompt_pad)
    jout = jeng.run(_reqs(jsched, LENS))
    tout = teng.run(_reqs(tsched, LENS))
    assert list(teng.done) == list(jeng.done)
    assert teng.steps_run == jeng.steps_run == tout["steps"] == jout["steps"]
    for rid, req in jeng.done.items():
        assert teng.done[rid].generated == req.generated, f"rid={rid}"
    assert tout["requests"] == len(LENS)
    assert tout["new_tokens"] == jout["new_tokens"]
    # the energy meter: the same J/token per request and in total
    assert teng.meter is not None and jeng.meter is not None
    for k in ("energy_j_total", "j_per_token", "static_worst_energy_j"):
        np.testing.assert_allclose(tout[k], jout[k], rtol=1e-4)
    assert tout["meter_policy_swaps"] == jout["meter_policy_swaps"] == 0
    for tr, jr in zip(tout["per_request"], jout["per_request"]):
        assert tr["request"] == jr["request"]
        for k in ("energy_j", "j_per_token", "j_per_decoded_token"):
            np.testing.assert_allclose(tr[k], jr[k], rtol=1e-4)


def test_fifo_admission_order(params):
    eng = _port_engine(params, capacity=1)
    out = eng.run(_reqs(tsched, [(4, 2), (5, 2), (3, 2)]))
    assert out["requests"] == 3
    # capacity 1: strictly sequential, done order == submit order
    assert list(eng.done) == [0, 1, 2]
    admits = [eng.done[r].t_admitted for r in (0, 1, 2)]
    assert admits == sorted(admits)


def test_slot_recycle_beats_fixed_batch(params):
    lens = [(4, 2), (4, 6), (4, 2), (4, 6), (4, 2), (4, 6)]
    cont = _port_engine(params, capacity=2).run(_reqs(tsched, lens))
    fixed = _port_engine(params, capacity=2, continuous=False).run(
        _reqs(tsched, lens))
    assert cont["requests"] == fixed["requests"] == len(lens)
    assert cont["new_tokens"] == fixed["new_tokens"]
    assert cont["steps"] < fixed["steps"]


def test_ragged_matches_sequential_oracle(params):
    """Bucketed prefill + per-row decode == the b = 1 exact-length serve
    path of the port, token for token."""
    lens = [(3, 5), (7, 4), (5, 6)]
    eng = _port_engine(params)
    reqs = _reqs(tsched, lens)
    eng.run([tsched.Request(r.rid, r.prompt.copy(), r.max_new_tokens)
             for r in reqs])
    for r in reqs:
        s1 = TShape("oracle", len(r.prompt) + r.max_new_tokens, 1, "decode")
        prefill = tsteps.build_prefill_step(eng.arch, s1, device="cpu")
        step = tsteps.build_serve_step(eng.arch, s1, device="cpu")
        with torch.inference_mode():
            logits, state = prefill(eng.params, {
                "tokens": torch.from_numpy(r.prompt)[None]})
            tok = torch.argmax(logits[:, -1], -1).to(torch.int32)[:, None]
            want = [int(tok[0, 0])]
            for _ in range(r.max_new_tokens - 1):
                tok, state = step(eng.params, tok, state)
                want.append(int(tok[0, 0]))
        assert eng.done[r.rid].generated == want, f"rid={r.rid}"


def test_preemption_drains_and_readmits(params):
    lens = [(4, 4), (5, 3), (3, 5), (6, 4), (4, 3)]
    eng = _port_engine(params, capacity=2)
    base = eng.run(_reqs(tsched, lens))
    base_out = {rid: list(r.generated) for rid, r in eng.done.items()}

    eng = _port_engine(params, capacity=2)
    fired = {"n": 0}

    def inject(step):
        if step == 2 and not fired["n"]:
            fired["n"] += 1
            raise ft.Preemption("injected")

    out = eng.run(_reqs(tsched, lens),
                  retry_policy=ft.RetryPolicy(backoff_s=0.0), inject=inject)
    assert fired["n"] == 1
    assert out["requests"] == base["requests"] == len(lens)   # zero lost
    assert sum(r.readmissions for r in eng.done.values()) >= 1
    assert {rid: list(r.generated) for rid, r in eng.done.items()} == \
        base_out


def test_preemption_replays_continuations_in_shared_steps(params,
                                                         monkeypatch):
    """After a drain the continuations replay their tokens together, in
    the engine's own decode steps: max(tokens held) - 1 steps carry a
    replaying row, the KV caches are made only at construction and at the
    drain (no scratch cache), and the outputs are the fault-free ones."""
    lens = [(4, 6), (5, 7), (3, 5), (6, 4)]
    eng = _port_engine(params, capacity=2)
    eng.run(_reqs(tsched, lens))
    base = {rid: list(r.generated) for rid, r in eng.done.items()}
    made = []
    init = tsched.transformer.init_caches
    monkeypatch.setattr(            # the slot caches (not a prefill's)
        tsched.transformer, "init_caches",
        lambda *a, **k: (k.get("per_row_idx") and made.append(a[0]))
        or init(*a, **k))
    eng = _port_engine(params, capacity=2)
    held = []

    def inject(step):
        if step == 3 and not held:
            held.append([len(s.request.generated) for s in eng.slots
                         if not s.free])
            raise ft.Preemption("injected")

    eng.run(_reqs(tsched, lens), retry_policy=ft.RetryPolicy(backoff_s=0.0),
            inject=inject)
    assert held == [[4, 4]]
    assert eng.replay_steps == 3
    assert made == [2, 2]
    assert all(not s.replay for s in eng.slots)
    assert {rid: list(r.generated) for rid, r in eng.done.items()} == base


def test_kv_plan_nets_out_the_parameters(params):
    """The slots are sized against the device memory less the parameters'
    bytes."""
    from repro_torch.optim.adamw import tree_leaves_with_path
    from repro_torch.roofline import model as troof
    eng = _port_engine(params)
    wbytes = sum(t.numel() * t.element_size()
                 for _, t in tree_leaves_with_path(params[1]))
    want = troof.plan_kv_cache(eng.cfg, 3, S_CACHE, block=8,
                               weight_bytes=wbytes)
    assert wbytes > 0 and eng.kv_plan == want
    assert want.budget_bytes < troof.plan_kv_cache(
        eng.cfg, 3, S_CACHE, block=8).budget_bytes


def test_submit_rejects_overflowing_request(params):
    eng = _port_engine(params, capacity=1)
    with pytest.raises(ValueError, match="exceeds"):
        eng.submit(tsched.Request(rid=99,
                                  prompt=np.zeros(S_CACHE, np.int32) + 3,
                                  max_new_tokens=4))


def test_warmup_leaves_outputs_unchanged(params):
    eng = _port_engine(params)
    base = eng.run(_reqs(tsched, LENS[:4]))
    want = {rid: list(r.generated) for rid, r in eng.done.items()}
    eng = _port_engine(params)
    eng.warmup()
    assert eng.steps_run == 0 and not eng.done and not eng.queue
    assert eng.admit_ms == [] and eng.decode_ms == []
    assert all(int(c["idx"].abs().sum()) == 0
               for c in eng._state["layers"])
    out = eng.run(_reqs(tsched, LENS[:4]))
    assert out["steps"] == base["steps"]
    assert {rid: list(r.generated) for rid, r in eng.done.items()} == want


def test_timings_cover_every_admission_and_decode_step(params):
    """One host time per admission and per decode step, continuous and
    lockstep alike, each positive; a preemption's re-admissions count."""
    lens = [(4, 2), (4, 6), (4, 2), (4, 6), (4, 2)]
    for continuous in (True, False):
        eng = _port_engine(params, capacity=2, continuous=continuous)
        eng.run(_reqs(tsched, lens))
        assert len(eng.admit_ms) == len(lens)
        assert len(eng.decode_ms) == eng.steps_run
        assert min(eng.admit_ms + eng.decode_ms) > 0
    eng = _port_engine(params, capacity=2)
    fired = []

    def inject(step):
        if step == 2 and not fired:
            fired.append(step)
            raise ft.Preemption("injected")

    eng.run(_reqs(tsched, lens), retry_policy=ft.RetryPolicy(backoff_s=0.0),
            inject=inject)
    readmitted = sum(r.readmissions for r in eng.done.values())
    assert readmitted >= 1
    assert len(eng.admit_ms) == len(lens) + readmitted
    assert len(eng.decode_ms) == eng.steps_run


def test_unported_options_raise(params):
    """The drift-adaptation options and `run(schedule=, trace=)` are
    ported now: none of them raises NotImplementedError any more (their
    parity is `tests/test_torch_drift.py`'s and `test_torch_chaos.py`'s)."""
    arch = _archs("quant")[1]
    for kw in (dict(adapt=True), dict(resolver=print),
               dict(supply_resolver=print), dict(scripted_swaps=[]),
               dict(drift_threshold=0.1, vdd_grid=(0.8, 0.6),
                    supply_span=False)):
        eng = tsched.ContinuousBatchingEngine(arch, params=params[1],
                                              device="cpu", kv_block=8,
                                              s_cache=S_CACHE, **kw)
        assert eng.adapt == kw.get("adapt", False)
    out = _port_engine(params).run(
        _reqs(tsched, LENS[:2]), retry_policy=ft.RetryPolicy(backoff_s=0.0),
        schedule=ft.FaultSchedule([ft.FaultEvent(1, "preempt")]),
        trace=ft.TrafficTrace([ft.TraceSegment(steps=4, load=0.5)]))
    assert out["requests"] == 2 and out["faults"] == [
        {"step": 1, "kind": "preempt"}]
    assert out["trace"]["total_steps"] == 4


def test_engine_defaults_to_cuda_and_raises_without_it(params, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    arch = _archs("quant")[1]
    with pytest.raises(RuntimeError, match="CUDA"):
        tsched.ContinuousBatchingEngine(arch, params=params[1])
    with pytest.raises(RuntimeError, match="CUDA"):
        tserve.run_scheduler(arch, 2, 4, 2, 2)
    eng = _port_engine(params)
    assert eng.device.type == "cpu" and eng._tok.device.type == "cpu"
    assert eng._state["layers"][0]["k"].dtype == torch.bfloat16
