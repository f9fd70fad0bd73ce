"""Port parity of the energy meter (`repro_torch.tdsim.energy_meter`), the
model's matmul ledger (`models.matmul_shapes`) and the serving engine's
energy telemetry against the JAX reference, on the CPU.

* `compare_domains(matmul_shapes(cfg), pol)` for full-width qwen3-8b (shapes
  only, no weights), where k % n_chain != 0 so the tail segment is priced
  apart: every layer's and the total's energy within rtol 1e-4, R exact.
* The meter's own arithmetic (re-pricing, epochs, the static worst case)
  against the reference's meter at the same rates.
* The CPU smoke engine with the meter on, at a scenario/corner policy,
  against the JAX engine: per-request energy_j, j_per_token and the
  summary's energy fields within rtol 1e-4; rows sum to the run total and
  the total is the rate times the tokens (rtol 1e-9).
* The serve CLI prints J/token in both modes.
"""
import numpy as np
import pytest

import repro.configs as jcfgs
from repro.configs.base import TDExecCfg as JTD
from repro.configs.base import TrainCfg as JTrain
from repro.core import explorer as jexplorer
from repro.launch import scheduler as jsched
from repro.models import matmul_shapes as jshapes
from repro.models import get_api as jget_api
from repro.tdsim import energy_meter as jmeter
from repro.tdsim import policy as jpolicy
import repro_torch.configs as tcfgs
from repro_torch.configs.base import TDExecCfg as TTD
from repro_torch.configs.base import TrainCfg as TTrain
from repro_torch.convert import params_from_jax
from repro_torch.core import explorer as texplorer
from repro_torch.launch import scheduler as tsched
from repro_torch.launch import serve as tserve
from repro_torch.models import matmul_shapes as tshapes
from repro_torch.tdsim import energy_meter as tmeter
from repro_torch.tdsim import policy as tpolicy

import jax


@pytest.fixture(scope="module", autouse=True)
def cpu_service():
    """The port's policy solves and pricing run on the CPU here."""
    prev = texplorer.set_service(texplorer.ExplorerService(device="cpu"))
    yield
    texplorer.set_service(prev)


def _pol_pair(kind):
    if kind == "exact":
        return (jpolicy.solve_td_policy(4, 4, 576, None),
                tpolicy.solve_td_policy(4, 4, 576, None))
    if kind == "relaxed":
        return (jpolicy.solve_td_policy(4, 4, 576, 1.0),
                tpolicy.solve_td_policy(4, 4, 576, 1.0))
    if kind == "vdd-opt-ss":
        j = jpolicy.solve_network_policies([2.0], n_chain=576,
                                           scenario="vdd-opt", corner="ss")
        t = tpolicy.solve_network_policies([2.0], n_chain=576,
                                           scenario="vdd-opt", corner="ss")
        return j.layers[0], t.layers[0]
    return jpolicy.quant_policy(), tpolicy.quant_policy()


def test_matmul_shapes_match_reference():
    for name in ("qwen3-8b", "granite-8b"):
        for get in ("get", "get_smoke"):
            jcfg = getattr(jcfgs, get)(name).model
            tcfg = getattr(tcfgs, get)(name).model
            assert [(s.name, s.k, s.n_out, s.calls_per_token)
                    for s in tshapes(tcfg)] == \
                [(s.name, s.k, s.n_out, s.calls_per_token)
                 for s in jshapes(jcfg)]


@pytest.mark.parametrize("kind", ["exact", "relaxed", "vdd-opt-ss",
                                  "quant"])
def test_compare_domains_full_width_qwen3_8b(kind):
    jpol, tpol = _pol_pair(kind)
    cfg = tcfgs.get("qwen3-8b").model
    assert cfg.d_model % 576 and cfg.d_ff % 576     # tails are priced
    sigma = None if kind != "quant" else 2.0
    got = tmeter.compare_domains(tshapes(cfg), tpol, sigma_max=sigma,
                                 device="cpu")
    want = jmeter.compare_domains(jshapes(jcfgs.get("qwen3-8b").model),
                                  jpol, sigma_max=sigma)
    assert list(got) == list(want) == ["td", "analog", "digital"]
    for dom in got:
        g, w = got[dom], want[dom]
        assert g.domain == w.domain and list(g.per_layer) == \
            list(w.per_layer)
        assert g.total_macs_per_token == w.total_macs_per_token
        np.testing.assert_allclose(g.total_energy_per_token,
                                   w.total_energy_per_token, rtol=1e-4)
        for name, row in g.per_layer.items():
            ref = w.per_layer[name]
            assert row["macs"] == ref["macs"] and row["r"] == ref["r"]
            for k in ("e_mac", "energy_j", "throughput", "area_per_mac"):
                np.testing.assert_allclose(row[k], ref[k], rtol=1e-4,
                                           err_msg=f"{dom}/{name}/{k}")
        assert g.summary().splitlines()[0].startswith(f"domain={dom}")


def test_request_meter_matches_reference():
    jpol, tpol = _pol_pair("exact")
    jrel, trel = _pol_pair("relaxed")
    cfg = tcfgs.get_smoke("qwen3-8b").model
    jm = jmeter.RequestMeter(jshapes(jcfgs.get_smoke("qwen3-8b").model),
                             jpol)
    tm = tmeter.RequestMeter(tshapes(cfg), tpol, device="cpu")
    for m, rel in ((jm, jrel), (tm, trel)):
        m.on_prefill("a", 7)
        m.on_decode("a")
        m.on_prefill("b", 3)
        m.set_policy(rel)
        m.on_decode("a", 2)
        m.on_decode("b")
        m.install(m.price(rel, sigma_max=0.5))
        m.on_decode("b", 4)
    assert tm.policy_swaps == jm.policy_swaps == 2
    assert tm.tokens_at_rate == jm.tokens_at_rate
    np.testing.assert_allclose(tm.rate_history, jm.rate_history, rtol=1e-4)
    for tr, jr in zip(tm.rows(), jm.rows()):
        assert tr.keys() == jr.keys()
        for k, v in jr.items():
            if isinstance(v, float):
                np.testing.assert_allclose(tr[k], v, rtol=1e-4)
            else:
                assert tr[k] == v
    np.testing.assert_allclose(tm.run_total_energy(), jm.run_total_energy(),
                               rtol=1e-4)
    assert tm.run_total_tokens() == jm.run_total_tokens() == 18
    np.testing.assert_allclose(
        sum(e["energy_j"] for e in tm.rate_epochs()), tm.run_total_energy(),
        rtol=1e-12)
    np.testing.assert_allclose(tm.static_worst_energy(),
                               jm.static_worst_energy(), rtol=1e-4)
    assert tm.request_energy("zz") == 0.0


LENS = [(5, 4), (3, 6), (8, 2), (4, 5), (6, 3)]


def _reqs(mod):
    rng = np.random.default_rng(11)
    return [mod.Request(rid=i,
                        prompt=rng.integers(3, 50, size=p).astype(np.int32),
                        max_new_tokens=g)
            for i, (p, g) in enumerate(LENS)]


@pytest.mark.parametrize("domain", ["td", "digital"])
def test_engine_energy_matches_reference_engine(domain):
    """The smoke engine at float32 compute, td at the vdd-opt scenario's ss
    corner (noise on): energy telemetry against the JAX engine's."""
    kw = dict(scenario="vdd-opt", corner="ss")
    ja = jcfgs.get_smoke("qwen3-8b").replace(
        td=JTD(mode="td", n_chain=64), train=JTrain(compute_dtype="float32"),
        **kw)
    ta = tcfgs.get_smoke("qwen3-8b").replace(
        td=TTD(mode="td", n_chain=64), train=TTrain(compute_dtype="float32"),
        **kw)
    jprev = jexplorer.set_service(jexplorer.ExplorerService())
    try:
        cfg = ja.model
        jp = jget_api(cfg)["init"](jax.random.key(0), cfg,
                                   jpolicy.quant_policy())
        tp = params_from_jax(jax.device_get(jp), cfg, device="cpu")
        jeng = jsched.ContinuousBatchingEngine(
            ja, capacity=2, s_cache=16, params=jp, kv_block=8,
            meter_domain=domain)
        teng = tsched.ContinuousBatchingEngine(
            ta, capacity=2, s_cache=16, params=tp, kv_block=8,
            meter_domain=domain, device="cpu")
        jout = jeng.run(_reqs(jsched))
        tout = teng.run(_reqs(tsched))
    finally:
        jexplorer.set_service(jprev)
    pol0 = teng.pol
    assert pol0.techlib.name.endswith("-ss") and pol0.vdd != 0.8
    assert teng.meter.domain == domain
    assert list(teng.done) == list(jeng.done)
    for k in ("energy_j_total", "j_per_token", "static_worst_energy_j"):
        np.testing.assert_allclose(tout[k], jout[k], rtol=1e-4)
    assert tout["meter_policy_swaps"] == 0
    assert len(tout["rate_epochs"]) == len(jout["rate_epochs"]) == 1
    for tr, jr in zip(tout["per_request"], jout["per_request"]):
        assert tr["request"] == jr["request"]
        for k in ("energy_j", "j_per_token", "j_per_decoded_token"):
            np.testing.assert_allclose(tr[k], jr[k], rtol=1e-4)
    rows = teng.request_rows()
    total = teng.meter.run_total_energy()
    assert all(r["energy_j"] > 0 and r["j_per_token"] > 0 for r in rows)
    np.testing.assert_allclose(sum(r["energy_j"] for r in rows), total,
                               rtol=1e-9)
    np.testing.assert_allclose(
        total, teng.meter.e_token * teng.meter.run_total_tokens(), rtol=1e-9)
    assert tout["energy_j_total"] == total


def test_precise_engine_has_no_meter():
    ta = tcfgs.get_smoke("qwen3-8b")
    eng = tsched.ContinuousBatchingEngine(ta, capacity=1, s_cache=16,
                                          kv_block=8, device="cpu")
    out = eng.run(_reqs(tsched)[:1])
    assert eng.meter is None and "energy_j_total" not in out
    assert "energy_j" not in out["per_request"][0]


def test_serve_cli_prints_j_per_token(capsys):
    out = tserve.main(["--smoke", "--device", "cpu", "--scheduler", "--td",
                       "td", "--scenario", "vdd-opt", "--corner", "ss",
                       "--streams", "3", "--capacity", "2", "--prompt-len",
                       "6", "--gen", "3"])
    text = capsys.readouterr().out
    assert "J/token" in text and "[serve/sched] TD energy" in text
    assert out["energy_j_total"] > 0 and out["j_per_token"] > 0
    np.testing.assert_allclose(
        sum(r["energy_j"] for r in out["per_request"]),
        out["energy_j_total"], rtol=1e-9)
    stats: dict = {}
    arch = tcfgs.get_smoke("qwen3-8b").replace(td=TTD(mode="td", n_chain=64),
                                               scenario="edge", corner="ff")
    tserve.run(arch, 1, 4, 2, device="cpu", stats=stats)
    text = capsys.readouterr().out
    assert text.count("[energy]") == 3 and "J/token" in text
    assert sorted(stats["j_per_token"]) == ["analog", "digital", "td"]
    ids = tserve.main(["--smoke", "--device", "cpu", "--td", "td",
                       "--td-per-layer", "exact,2.0", "--batch", "1",
                       "--prompt-len", "4", "--gen", "2"])
    assert ids.shape == (1, 2)
    # --adapt belongs to scheduler mode: the fixed batch ignores it, as the
    # reference's CLI does
    ids = tserve.main(["--smoke", "--device", "cpu", "--adapt", "--batch",
                       "1", "--prompt-len", "4", "--gen", "2"])
    assert ids.shape == (1, 2)
    ids = tserve.main(["--smoke", "--device", "cpu", "--td", "td",
                       "--td-attn", "td", "--batch", "1", "--prompt-len",
                       "4", "--gen", "2"])
    assert ids.shape == (1, 2) and "J/token" in capsys.readouterr().out
