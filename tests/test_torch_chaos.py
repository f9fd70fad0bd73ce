"""Port parity of the chaos engine (`repro_torch.ft.chaos`), the explorer
client and server (`repro_torch.launch.explore`) and the serving engine
under a fault schedule, against the reference (`repro.ft.chaos`,
`repro.launch.explore`, `repro.launch.scheduler`).

* `FaultSchedule` and `TrafficTrace`: for the same events and seeds the
  JSON text is byte-equal to the reference's; the reference's property
  tests (`tests/test_drift_traces.py:121-235`) run as parametrised cases,
  each also against the reference's own generation.
* `corrupt_checkpoint` on the port's checkpoint layout.
* The explorer client: a dead server fails fast with `ExplorerUnreachable`,
  and `resolve_with_fallback` answers "local" and then, against the
  port's own `ExplorerServer`, "remote" with the same policies.
* The chaos-parity schedule (stall, preemption, explorer outage) in quant
  mode gives the fault-free tokens, in both packages, on the same
  parameters (float32 compute: XLA's CPU jit drops bf16 roundings).
"""
import torch_threads  # noqa: F401  (first: torch's threads under xdist)
import time

import numpy as np
import pytest

import jax
import repro.configs as jcfgs
from repro import ft as jft
from repro.configs.base import TDExecCfg as JTD
from repro.configs.base import TrainCfg as JTrain
from repro.launch import scheduler as jsched
from repro.models import get_api as jget_api
from repro.tdsim.policy import quant_policy as jquant
import repro_torch.configs as tcfgs
from repro_torch import ft
from repro_torch.checkpoint import ckpt
from repro_torch.configs.base import TDExecCfg as TTD
from repro_torch.configs.base import TrainCfg as TTrain
from repro_torch.convert import params_from_jax
from repro_torch.core import explorer as texplorer
from repro_torch.launch import explore
from repro_torch.launch import scheduler as tsched
from repro_torch.tdsim import policy as tpolicy

# (seed, steps, n_segments): the property tests' ranges, fixed
TRACE_CASES = [(0, 1, 1), (1, 2, 5), (7, 100, 6), (11, 64, 6),
               (123, 300, 12), (2 ** 31 - 1, 500, 3), (42, 17, 17)]
FAULT_CASES = [(0, 2), (3, 20), (7, 50), (8, 50), (99, 1000)]


# ---------------------------------------------------------------------------
# fault schedules and traffic traces: byte-equal to the reference
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("seed,steps", FAULT_CASES)
def test_fault_schedule_generate_matches_reference(seed, steps):
    a = ft.FaultSchedule.generate(seed=seed, steps=steps)
    assert a.to_json() == jft.FaultSchedule.generate(seed=seed,
                                                     steps=steps).to_json()
    assert a.to_json() == ft.FaultSchedule.generate(seed=seed,
                                                    steps=steps).to_json()
    assert all(ev.kind in ft.CHAOS_KINDS for ev in a.pending)
    back = ft.FaultSchedule.from_json(a.to_json())
    assert back.pending == a.pending and back.to_json() == a.to_json()


def test_fault_schedule_json_and_fire_once(tmp_path):
    events = [(3, "stall", {"duration_s": 0.1}),
              (5, "ckpt_corrupt", {"mode": "bitflip", "seed": 9}),
              (7, "preempt", {}), (8, "drift", {"factor": 0.5}),
              (9, "explorer_outage", {"up": False})]
    t = ft.FaultSchedule([ft.FaultEvent(*e) for e in events], seed=42)
    j = jft.FaultSchedule([jft.FaultEvent(*e) for e in events], seed=42)
    assert t.to_json() == j.to_json()
    assert ft.FaultSchedule.load(t.save(str(tmp_path / "s.json"))
                                 ).to_json() == t.to_json()
    assert t.pop(1) == []
    fired = t.pop(7)          # a restart that skipped steps 3 and 5
    assert [ev.kind for ev in fired] == ["stall", "ckpt_corrupt", "preempt"]
    assert t.pop(7) == []
    assert [ev.kind for ev in t.pending] == ["drift", "explorer_outage"]
    with pytest.raises(ValueError, match="unknown fault kind"):
        ft.FaultEvent(1, "meteor_strike")


@pytest.mark.parametrize("seed,steps,n_segments", TRACE_CASES)
def test_trace_generate_matches_reference_and_round_trips(seed, steps,
                                                          n_segments):
    t = ft.TrafficTrace.generate(seed, steps, n_segments=n_segments)
    j = jft.TrafficTrace.generate(seed, steps, n_segments=n_segments)
    assert t.to_json() == j.to_json()
    assert t == ft.TrafficTrace.generate(seed, steps, n_segments=n_segments)
    assert t.total_steps == max(1, steps)
    lo, hi = ft.chaos.ACTIVITY_BOUNDS
    for seg in t.segments:
        assert seg.steps >= 1 and lo <= seg.activity <= hi
        assert 0.0 <= seg.sparsity <= 1.0 and 0.0 < seg.load <= 1.0
    back = ft.TrafficTrace.from_json(t.to_json())
    assert back == t and back.to_json() == t.to_json()
    bench = dict(activity_range=(0.2, 1.8), sparsity_range=(0.5, 0.9),
                 load_range=(0.4, 1.0))
    assert ft.TrafficTrace.generate(seed, steps, n_segments, **bench
                                    ).to_json() == \
        jft.TrafficTrace.generate(seed, steps, n_segments, **bench).to_json()


@pytest.mark.parametrize("seed,steps,n_segments", TRACE_CASES)
def test_trace_boundaries_gapless_and_excursion(seed, steps, n_segments):
    t = ft.TrafficTrace.generate(seed, steps, n_segments=n_segments)
    b = t.boundaries()
    assert b == jft.TrafficTrace.generate(
        seed, steps, n_segments=n_segments).boundaries()
    assert b[0][0] == 0 and b[-1][1] == t.total_steps
    for (s0, e0), (s1, _e1) in zip(b, b[1:]):
        assert s0 < e0 == s1
    for i, (s, e) in enumerate(b):
        assert t.segment_index(s) == i and t.segment_index(e - 1) == i
    assert t.at(t.total_steps + 999) is t.segments[-1]
    np.testing.assert_array_equal(
        t.activity_curve(steps + 3),
        jft.TrafficTrace.generate(seed, steps, n_segments=n_segments
                                  ).activity_curve(steps + 3))
    walk = ft.excursion_trace(seed, steps)
    np.testing.assert_array_equal(walk, jft.excursion_trace(seed, steps))
    assert walk.shape == (steps,) and np.all((walk >= 0.05) & (walk <= 0.95))
    if steps >= 16:
        a = ft.TrafficTrace.from_excursion(seed, steps, segment=16)
        assert a.to_json() == jft.TrafficTrace.from_excursion(
            seed, steps, segment=16).to_json()


def test_trace_fixed_cases_and_validation():
    segs = [(5, 1.2, 0.8, 0.5), (3, 0.3, None, 1.0)]
    t = ft.TrafficTrace([ft.TraceSegment(*s) for s in segs], seed=9)
    assert t.to_json() == jft.TrafficTrace(
        [jft.TraceSegment(*s) for s in segs], seed=9).to_json()
    assert ft.TrafficTrace.from_json(t.to_json()).segments[1].sparsity \
        is None
    t = ft.TrafficTrace([ft.TraceSegment(4, 1.0), ft.TraceSegment(6, 0.5)])
    assert t.boundaries() == [(0, 4), (4, 10)]
    assert t.at(10 ** 9).activity == 0.5
    for bad in (lambda: ft.TraceSegment(0),
                lambda: ft.TraceSegment(4, activity=99.0),
                lambda: ft.TraceSegment(4, sparsity=1.5),
                lambda: ft.TraceSegment(4, load=0.0),
                lambda: ft.TrafficTrace([]), lambda: t.at(-1)):
        with pytest.raises(ValueError):
            bad()


# ---------------------------------------------------------------------------
# the storage-fault injector on the port's layout
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("mode", ft.CORRUPT_MODES)
def test_corrupt_checkpoint_modes(tmp_path, mode):
    d = str(tmp_path)
    for s in (1, 2):
        ckpt.save(d, s, {"w": np.full((8, 8), float(s), np.float32)},
                  async_write=False)
    hit = ft.corrupt_checkpoint(d, mode, seed=5)
    if mode == "tmp_litter":
        assert hit is None and ckpt.latest_steps(d) == [1, 2]
        assert (tmp_path / "step_00000003.tmp" / ckpt.MANIFEST).exists()
        ckpt.verify(d, 2)
        return
    assert hit == 2
    with pytest.raises(ckpt.CorruptCheckpoint):
        ckpt.verify(d, 2)
    ckpt.verify(d, 1)
    with pytest.raises(ValueError, match="corruption mode"):
        ft.corrupt_checkpoint(d, "melt")


# ---------------------------------------------------------------------------
# explorer client and server
# ---------------------------------------------------------------------------
def test_explorer_client_dead_server_then_own_server():
    specs = [tpolicy.TDLayerSpec(bits_a=4, bits_w=4, n_chain=64,
                                 sigma_max=2.0)]
    t0 = time.monotonic()
    with pytest.raises(explore.ExplorerUnreachable) as ei:
        explore.request({"op": "ping"}, host="127.0.0.1", port=1,
                        connect_timeout=0.2, retries=1, backoff_s=0.0,
                        retry_seed=0)
    assert time.monotonic() - t0 < 5.0
    assert isinstance(ei.value, ConnectionError)
    assert any(issubclass(explore.ExplorerUnreachable, t)
               for t in ft.RETRYABLE)
    before = texplorer.service().stats.fallback_resolves
    pols, source = explore.resolve_with_fallback(
        specs, host="127.0.0.1", port=1, connect_timeout=0.2, retries=0,
        backoff_s=0.0, device="cpu")
    assert source == "local"
    assert texplorer.service().stats.fallback_resolves == before + 1
    local = tpolicy.solve_td_policies(specs, "cpu")

    # the server's solves route through the process-wide service, as
    # under the CLI's main()
    svc = texplorer.ExplorerService(device="cpu")
    prev = texplorer.set_service(svc)
    server = explore.ExplorerServer(svc, port=0).start_background()
    try:
        host, port = server.address
        rpols, source = explore.resolve_with_fallback(
            specs, host=host, port=port, connect_timeout=2.0, retries=0)
        assert source == "remote"
        assert rpols == pols == local
        span, _ = explore.resolve_with_fallback(
            [tpolicy.TDLayerSpec(sigma_max=2.0, p_x_one=0.125,
                                 w_bit_sparsity=0.85)], host=host,
            port=port, vdd_grid=(0.8, 0.52), retries=0)
        assert span[0].vdd == 0.52
        pong = explore.request({"op": "ping"}, host=host, port=port)
        assert pong["ok"] and "vdd-opt" in pong["scenarios"]
        stats = explore.request({"op": "stats"}, host=host, port=port)
        assert stats["ok"] and stats["stats"]["td_queries"] >= 1
        ref = explore.request({"op": "refine", "scenario": "edge",
                               "target": 64, "coarse": 5,
                               "max_axis_values": 16}, host=host, port=port)
        assert ref["ok"] and ref["dense_size"] == 64
        assert ref["evaluated_axis_values"] <= 16
        assert not explore.request({"op": "nope"}, host=host,
                                   port=port)["ok"]
        assert explore.request({"op": "shutdown"}, host=host,
                               port=port)["ok"]
    finally:
        server.shutdown()
        texplorer.set_service(prev)


# ---------------------------------------------------------------------------
# the serving engine under the chaos-parity schedule, both packages
# ---------------------------------------------------------------------------
LENS = [(5, 6), (3, 4), (6, 6), (4, 5), (5, 3)]


def _reqs(mod):
    rng = np.random.default_rng(11)
    return [mod.Request(rid=i,
                        prompt=rng.integers(3, 50, size=p).astype(np.int32),
                        max_new_tokens=g)
            for i, (p, g) in enumerate(LENS)]


def _schedule(mod):
    return mod.FaultSchedule([
        mod.FaultEvent(1, "stall", {"duration_s": 0.01}),
        mod.FaultEvent(3, "preempt"),
        mod.FaultEvent(5, "explorer_outage", {"up": False})])


def test_chaos_schedule_parity_in_both_packages():
    cfg = jcfgs.get_smoke("qwen3-8b").model
    jp = jget_api(cfg)["init"](jax.random.key(0), cfg, jquant())
    tp = params_from_jax(jax.device_get(jp), cfg, device="cpu")
    ja = jcfgs.get_smoke("qwen3-8b").replace(
        td=JTD(mode="quant"), train=JTrain(compute_dtype="float32"))
    ta = tcfgs.get_smoke("qwen3-8b").replace(
        td=TTD(mode="quant"), train=TTrain(compute_dtype="float32"))
    outs = {}
    for name, mod, fmod, arch, params, kw in (
            ("ref", jsched, jft, ja, jp, {}),
            ("port", tsched, ft, ta, tp, {"device": "cpu"})):
        for chaos in (False, True):
            eng = mod.ContinuousBatchingEngine(arch, capacity=2, s_cache=16,
                                               params=params, kv_block=8,
                                               **kw)
            seen = []
            eng.on_outage = seen.append
            out = eng.run(_reqs(mod),
                          retry_policy=fmod.RetryPolicy(backoff_s=0.0),
                          schedule=_schedule(fmod) if chaos else None)
            assert out["requests"] == len(LENS)              # zero lost
            outs[name, chaos] = {rid: list(r.generated)
                                 for rid, r in eng.done.items()}
            if chaos:
                assert {f["kind"] for f in out["faults"]} == \
                    {"stall", "preempt", "explorer_outage"}
                # the port rebuilds a continuation by replaying its tokens
                assert name == "ref" or eng.replay_steps >= 1
                assert sum(r["readmissions"] for r in out["per_request"]) \
                    >= 1
                assert seen == [False] and not eng.explorer_up
    assert outs["port", True] == outs["port", False] == outs["ref", False] \
        == outs["ref", True]
