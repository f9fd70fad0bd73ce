"""Port parity of the policy solves (`repro_torch.tdsim.policy`), their
resolution from an ArchConfig (`models.common`) and the CLI plumbing
(`launch.td_cli`) against the JAX reference, on the CPU.

Tolerances: R, q, vdd and every other operating-point field exact;
sigma_chain within 1e-6 relative (the reference's compiled solve fuses
multiply-adds into FMAs, the port rounds each op: an ulp apart at some
keys).  A technology library compares by `content_hash`.  Each port path
is held to the same reference path (`solve_network_policies` to the
reference's `solve_network_policies`, not to its scalar wrapper).
"""
import torch_threads  # noqa: F401  (first: torch's threads under xdist)
import dataclasses
import json

import numpy as np
import pytest

import repro.configs as jcfgs
from repro.configs.base import TDExecCfg as JTD
from repro.core import explorer as jexplorer
from repro.launch import td_cli as jcli
from repro.models import common as jcommon
from repro.tdsim import policy as jpolicy
import repro_torch.configs as tcfgs
from repro_torch.configs.base import TDExecCfg as TTD
from repro_torch.core import explorer as texplorer
from repro_torch.launch import td_cli as tcli
from repro_torch.models import common as tcommon
from repro_torch.tdsim import policy as tpolicy

EXACT = ("mode", "bits_a", "bits_w", "n_chain", "redundancy", "tdc_q", "m",
         "tdc_arch", "vdd", "p_x_one", "w_bit_sparsity", "sigma_max")


def _assert_pol(got, want):
    assert type(got).__name__ == type(want).__name__
    if isinstance(want, jpolicy.NetworkPolicy):
        assert len(got) == len(want)
        for g, w in zip(got.layers, want.layers):
            _assert_pol(g, w)
        _assert_pol(got.top, want.top)
        assert (got.attn is None) == (want.attn is None)
        for g, w in zip(got.attn or (), want.attn or ()):
            _assert_pol(g, w)
        assert got.homogeneous == want.homogeneous
        return
    for f in EXACT:
        assert getattr(got, f) == getattr(want, f), f
    np.testing.assert_allclose(got.sigma_chain, want.sigma_chain, rtol=1e-6)
    assert (got.techlib is None) == (want.techlib is None)
    if want.techlib is not None:
        assert got.techlib.content_hash() == want.techlib.content_hash()


def _tlib(jlib):
    """The port's library with the same content as the reference's."""
    from repro_torch.core import scenario as tscenario
    if jlib is None:
        return None
    for c in tscenario.CORNERS.values():
        tl = c.apply_lib()
        if tl.content_hash() == jlib.content_hash():
            return tl
    raise AssertionError(jlib.name)


def _tspec(js):
    return tpolicy.TDLayerSpec(**{**dataclasses.asdict(js),
                                  "techlib": _tlib(js.techlib)})


@pytest.fixture(autouse=True)
def fresh_services():
    """Fresh explorer services in both packages (the port's on the CPU),
    so every test solves and caches on its own."""
    jprev = jexplorer.set_service(jexplorer.ExplorerService())
    tprev = texplorer.set_service(texplorer.ExplorerService(device="cpu"))
    yield
    jexplorer.set_service(jprev)
    texplorer.set_service(tprev)


KEYS = [(4, 4, 16, None), (4, 4, 16, 2.0), (4, 4, 48, None), (4, 4, 48, 2.0),
        (4, 4, 64, None), (4, 4, 64, 2.0), (4, 4, 576, None),
        (4, 4, 576, 2.0), (2, 3, 100, 0.7), (8, 8, 64, None),
        (4, 4, 576, 0.5, 0.6), (3, 2, 300, 4.0, 0.72)]


@pytest.mark.parametrize("key", KEYS, ids=str)
def test_solve_td_policy_matches_reference(key):
    _assert_pol(tpolicy.solve_td_policy(*key), jpolicy.solve_td_policy(*key))


def test_solve_td_policy_device_argument_and_memo():
    svc = texplorer.service()
    a = tpolicy.solve_td_policy(2, 3, 100, 0.7, device="cpu")
    b = tpolicy.solve_td_policy(2, 3, 100, 0.7)
    assert a == b and svc.stats.td_queries == 2 and svc.stats.td_hits == 1


def _mixed_specs():
    from repro.core import scenario as jscenario
    ss = jscenario.CORNERS["ss"].apply_lib()
    return [jpolicy.TDLayerSpec(4, 4, 576, None),
            jpolicy.TDLayerSpec(4, 4, 64, 2.0, vdd=0.6),
            jpolicy.TDLayerSpec(2, 8, 128, 1.0, p_x_one=0.3),
            jpolicy.TDLayerSpec(4, 4, 576, 0.5, m=16, tdc_arch="sar"),
            jpolicy.TDLayerSpec(4, 2, 1000, None, w_bit_sparsity=0.9),
            jpolicy.TDLayerSpec(4, 4, 576, 2.0, techlib=ss),
            jpolicy.TDLayerSpec(4, 4, 48, 2.0)]


def test_solve_td_policies_mixed_batch():
    js = _mixed_specs()
    for g, w in zip(tpolicy.solve_td_policies([_tspec(s) for s in js]),
                    jpolicy.solve_td_policies(js)):
        _assert_pol(g, w)


def test_solve_td_policies_over_vdd():
    js = _mixed_specs()
    for vdds in (None, (0.8, 0.6, 0.45)):
        got = tpolicy.solve_td_policies_over_vdd([_tspec(s) for s in js],
                                                 vdds)
        want = jpolicy.solve_td_policies_over_vdd(js, vdds)
        for g, w in zip(got, want):
            _assert_pol(g, w)


@pytest.mark.parametrize("scenario", ["vdd-opt", "edge"])
@pytest.mark.parametrize("corner", ["tt", "ss"])
def test_apply_scenario(scenario, corner):
    js = [jpolicy.TDLayerSpec(4, 4, 576, None),
          jpolicy.TDLayerSpec(4, 4, 64, 2.0),
          jpolicy.TDLayerSpec(2, 2, 256, 1.0)]
    for minimize_vdd in (True, False):
        got = tpolicy.apply_scenario([_tspec(s) for s in js], scenario,
                                     corner, minimize_vdd)
        want = jpolicy.apply_scenario(js, scenario, corner, minimize_vdd)
        for g, w in zip(got, want):
            assert g.techlib.content_hash() == w.techlib.content_hash()
            assert dataclasses.replace(g, techlib=None) == \
                _tspec(dataclasses.replace(w, techlib=None))
        for g, w in zip(tpolicy.solve_td_policies(got),
                        jpolicy.solve_td_policies(want)):
            _assert_pol(g, w)


@pytest.mark.parametrize("kw", [
    dict(sigma_max=[None, 2.0, 0.5, None, 1.0]),
    dict(sigma_max=[2.0, None, 0.7], bits_w=[4, 2, 4], n_chain=[576, 64, 48],
         vdd=0.6),
    dict(sigma_max=[None, 2.0, 1.0], scenario="vdd-opt", corner="ss"),
    dict(sigma_max=[0.5, 4.0], scenario="edge", corner="ff",
         minimize_vdd=False),
], ids=["plain", "broadcast", "vdd-opt-ss", "edge-ff-fixed-vdd"])
def test_solve_network_policies_matches_reference(kw):
    _assert_pol(tpolicy.solve_network_policies(**kw),
                jpolicy.solve_network_policies(**kw))


def _smoke_pair(**kw):
    ja = jcfgs.get_smoke("qwen3-8b")
    ta = tcfgs.get_smoke("qwen3-8b")
    n = ja.model.n_layers
    sig = [None, 1.0, 2.0, 0.5][:n] + [2.0] * max(0, n - 4)
    jl = tuple(JTD(mode="td", n_chain=64, sigma_max=s) for s in sig)
    tl = tuple(TTD(mode="td", n_chain=64, sigma_max=s) for s in sig)
    ja = ja.replace(td=JTD(mode="td", n_chain=64), **kw)
    ta = ta.replace(td=TTD(mode="td", n_chain=64), **kw)
    return ja, ta, jl, tl


@pytest.mark.parametrize("kw", [dict(), dict(scenario="vdd-opt",
                                             corner="ss"),
                                dict(corner="ff")],
                         ids=["plain", "vdd-opt-ss", "corner-only"])
def test_resolve_arch_policy(kw):
    ja, ta, jl, tl = _smoke_pair(**kw)
    _assert_pol(tcommon.resolve_arch_policy(ta),
                jcommon.resolve_arch_policy(ja))
    _assert_pol(tcommon.resolve_arch_policy(ta.replace(td_per_layer=tl)),
                jcommon.resolve_arch_policy(ja.replace(td_per_layer=jl)))
    with pytest.raises(ValueError, match="entries"):
        tcommon.resolve_arch_policy(ta.replace(td_per_layer=tl[:1]))
    # TD attention: one policy a query head, n_chain clamped to the head
    # dim, on a promoted NetworkPolicy and beside per-layer policies
    for attn in ("td", "quant"):
        _assert_pol(
            tcommon.resolve_arch_policy(ta.replace(td_attn=TTD(mode=attn))),
            jcommon.resolve_arch_policy(ja.replace(td_attn=JTD(mode=attn))))
    _assert_pol(tcommon.resolve_arch_policy(ta.replace(
        td_per_layer=tl, td_attn=TTD(mode="td", sigma_max=2.0))),
        jcommon.resolve_arch_policy(ja.replace(
            td_per_layer=jl, td_attn=JTD(mode="td", sigma_max=2.0))))
    mixed = [TTD(), TTD(mode="quant"), TTD(mode="td", n_chain=64)]
    jmixed = [JTD(), JTD(mode="quant"), JTD(mode="td", n_chain=64)]
    for g, w in zip(tcommon.resolve_policies(mixed, **kw),
                    jcommon.resolve_policies(jmixed, **kw)):
        _assert_pol(g, w)


def test_parse_td_per_layer_and_apply_td_args(tmp_path):
    ja, ta = jcfgs.get_smoke("qwen3-8b"), tcfgs.get_smoke("qwen3-8b")
    n = ja.model.n_layers
    doc = {"layers": [{"sigma_max": 0.5 * (i + 1), "n_chain": 32 + i}
                      for i in range(n)]}
    path = tmp_path / "per_layer.json"
    path.write_text(json.dumps(doc))
    one = tmp_path / "one.json"
    one.write_text(json.dumps([{"sigma_max": None, "bits_w": 2}]))
    specs = ["exact", "1.5", ",".join((["exact", "2.0"] * n)[:n]),
             f"@{path}", f"@{one}"]
    for spec in specs:
        got = tcli.parse_td_per_layer(spec, TTD(), n)
        want = jcli.parse_td_per_layer(spec, JTD(), n)
        assert [dataclasses.asdict(g) for g in got] == \
            [dataclasses.asdict(w) for w in want]
    with pytest.raises(ValueError, match="layers"):
        tcli.parse_td_per_layer("1.0,2.0" + ",3.0" * n, TTD(), n)
    for args in [("td", None), ("quant", "0.5"), (None, "exact"),
                 ("td", None, "edge", "ss"), ("td", None, None, "ff"),
                 ("td", f"@{path}", "vdd-opt")]:
        got = tcli.apply_td_args(ta, *args)
        want = jcli.apply_td_args(ja, *args)
        assert dataclasses.asdict(got.td) == dataclasses.asdict(want.td)
        assert (got.scenario, got.corner) == (want.scenario, want.corner)
        assert (got.td_per_layer is None) == (want.td_per_layer is None)
        if want.td_per_layer is not None:
            assert [dataclasses.asdict(t) for t in got.td_per_layer] == \
                [dataclasses.asdict(t) for t in want.td_per_layer]
    for args in [("td", None, "no-such-scenario"),
                 ("td", None, None, "xx")]:
        with pytest.raises(ValueError):
            tcli.apply_td_args(ta, *args)
