"""Port parity of the design-space engine (`repro_torch.core`) against the
JAX reference (`repro.core`), on the CPU.

* Module by module (cells, chain, tdc, analog, digital), on the same numpy
  inputs: integer results exact, floats within rtol 1e-5 (plus atol 1e-8
  for the INL moments mu and mu1, sums of signed terms of order 1e-2 that
  cancel to near zero, so that a last-bit difference in the summation
  order is a large relative one).
* The technology library's `content_hash` equals the reference's for the
  default library and at the tt, ff and ss corners.
* The golden fixture `tests/fixtures/design_space_golden.json` through the
  port's `design_space.evaluate` and `sweep_batched`, under the assertions
  of `tests/test_design_space_golden.py`: R, q and the winner exact, floats
  within rtol 1e-4.
* Grid by grid, the port's sweep against the reference's: the golden grid
  and the paper-exact, paper-relaxed, vdd-opt, edge and periphery
  scenarios at every corner.  Every integer field and winner equal, every
  float field within rtol 1e-4; then the reductions (`minimize_over_*`,
  Pareto frontier, crossovers, winner intervals) equal, and a grid the
  reference saved loads in the port.
* The explorer service: memo hits with the reference's stats counts,
  copies returned, the unported options raising.
"""
import torch_threads  # noqa: F401  (first: torch's threads under xdist)
import json
import os

import numpy as np
import pytest
import torch

from repro.core import analog as janalog
from repro.core import cells as jcells
from repro.core import chain as jchain
from repro.core import design_grid as jgrid
from repro.core import design_space as jds
from repro.core import digital as jdigital
from repro.core import explorer as jexplorer
from repro.core import scenario as jscenario
from repro.core import tdc as jtdc
from repro.core import techlib as jtechlib
from repro_torch.core import analog as tanalog
from repro_torch.core import cells as tcells
from repro_torch.core import chain as tchain
from repro_torch.core import design_grid as tgrid
from repro_torch.core import design_space as tds
from repro_torch.core import digital as tdigital
from repro_torch.core import explorer as texplorer
from repro_torch.core import scenario as tscenario
from repro_torch.core import tdc as ttdc
from repro_torch.core import techlib as ttechlib

import jax.numpy as jnp

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures",
                       "design_space_golden.json")
NS = (16, 32, 64, 128, 256, 576, 1024, 2048, 4096)
BITS = (1, 2, 4, 8)
INT_FIELDS = ("redundancy", "tdc_q", "l_osc")
FLOAT_FIELDS = ("e_mac", "throughput", "area_per_mac", "sigma_chain",
                "latency")
CORNERS = ("tt", "ff", "ss")

rng = np.random.default_rng(0)
VDD = rng.uniform(0.40, 0.84, 64).astype(np.float32)
P1 = rng.uniform(0.2, 0.8, 64).astype(np.float32)
WSP = rng.uniform(0.3, 0.95, 64).astype(np.float32)
N = rng.integers(8, 4097, 64).astype(np.float32)
UNITS = (N * rng.uniform(1, 200, 64)).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _j(a):
    return jnp.asarray(np.asarray(a))


def _close(got, want, rtol=1e-5, atol=0.0):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol)


def _libs():
    return {"default": (jtechlib.DEFAULT_LIB, ttechlib.DEFAULT_LIB),
            **{c: (jtechlib.DEFAULT_LIB.at_corner(jscenario.CORNERS[c]),
                   ttechlib.DEFAULT_LIB.at_corner(tscenario.CORNERS[c]))
               for c in CORNERS}}


# ---------------------------------------------------------------------------
# the library
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", ["default", *CORNERS])
def test_techlib_content_hash_matches_reference(name):
    jl, tl = _libs()[name]
    assert tl.content_hash() == jl.content_hash()
    assert tl == ttechlib.get_techlib(tl) and hash(tl) == hash(tl)


# ---------------------------------------------------------------------------
# module by module
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("cell", ["inverter", "delay_cell", "tristate"])
def test_eta_esnr_vs_vdd(cell):
    _close(tcells.eta_esnr_vs_vdd(cell, _t(VDD)),
           jcells.eta_esnr_vs_vdd(cell, _j(VDD)))


@pytest.mark.parametrize("bits", BITS)
@pytest.mark.parametrize("lib", ["default", "ss"])
def test_cell_energy_per_mac(bits, lib):
    jl, tl = _libs()[lib]
    r = rng.integers(1, 500, 64).astype(np.float32)
    _close(tcells.cell_energy_per_mac(bits, _t(r), _t(VDD), _t(P1), _t(WSP),
                                      tl),
           jcells.cell_energy_per_mac(bits, _j(r), _j(VDD), _j(P1), _j(WSP),
                                      jl))
    _close(tcells.tdmac_area(bits, _t(r)), jcells.tdmac_area(bits, _j(r)))


@pytest.mark.parametrize("bits,r,vdd", [(1, 1.0, 0.8), (4, 3.0, 0.52),
                                        (4, 76.0, 0.8), (8, 12.0, 0.4)])
def test_cell_stats(bits, r, vdd):
    want = jchain.cell_stats(bits, r, vdd)
    got = tchain.cell_stats(bits, r, vdd)
    for f in ("mu", "evpv", "vhm"):
        assert isinstance(getattr(got, f), float)
        _close(getattr(got, f), getattr(want, f),
               atol=1e-8 if f == "mu" else 0.0)


@pytest.mark.parametrize("bits", [1, 2, 3, 4, 8])
def test_cell_var_coeffs(bits):
    got = tchain.cell_var_coeffs(bits, _t(VDD), _t(P1), _t(WSP))
    want = jchain.cell_var_coeffs(bits, _j(VDD), _j(P1), _j(WSP))
    for f in ("a1", "c", "mu1"):
        _close(getattr(got, f), getattr(want, f),
               atol=1e-8 if f == "mu1" else 0.0)


@pytest.mark.parametrize("bits", [2, 4, 8])
def test_solve_redundancy_both_branches(bits):
    sig = rng.uniform(0.1, 4.0, 64).astype(np.float32)
    got = tchain.solve_redundancy(_t(N), bits, _t(sig), _t(VDD),
                                  p_x_one=_t(P1), w_bit_sparsity=_t(WSP))
    want = jchain.solve_redundancy(_j(N), bits, _j(sig), _j(VDD),
                                   p_x_one=_j(P1), w_bit_sparsity=_j(WSP))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for i in range(0, 64, 8):
        args = (float(N[i]), bits, float(sig[i]), float(VDD[i]))
        r = tchain.solve_redundancy(*args)
        assert isinstance(r, int) and r == jchain.solve_redundancy(*args)
    _close(tchain.chain_sigma(_t(N), bits, _t(got.float()), _t(VDD)),
           jchain.chain_sigma(_j(N), bits, jnp.asarray(want, jnp.float32),
                              _j(VDD)))


@pytest.mark.parametrize("m", [2, 8, 32])
def test_optimal_l_osc_both_branches(m):
    got = ttdc.optimal_l_osc(_t(UNITS), m, _t(VDD))
    want = jtdc.optimal_l_osc(_j(UNITS), m, _j(VDD))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for i in range(0, 64, 8):
        args = (float(UNITS[i]), m, float(VDD[i]))
        assert ttdc.optimal_l_osc(*args) == jtdc.optimal_l_osc(*args)
    _close(ttdc.hybrid_tdc_energy(_t(UNITS), got, m, _t(VDD)),
           jtdc.hybrid_tdc_energy(_j(UNITS), want, m, _j(VDD)))
    _close(ttdc.hybrid_tdc_latency(_t(UNITS), got, _t(VDD)),
           jtdc.hybrid_tdc_latency(_j(UNITS), want, _j(VDD)))
    _close(ttdc.hybrid_tdc_area(_t(UNITS), got, m),
           jtdc.hybrid_tdc_area(_j(UNITS), want, m))


@pytest.mark.parametrize("bits", [1, 4, 8])
def test_sar_tdc_and_range(bits):
    steps = ttdc.effective_range_steps(_t(N), bits)
    _close(steps, jtdc.effective_range_steps(_j(N), bits))
    b = ttdc.range_bits(steps)
    np.testing.assert_array_equal(
        b.numpy(), np.asarray(jtdc.range_bits(_j(steps.numpy()))))
    _close(ttdc.sar_tdc_energy(b, 8, _t(VDD)),
           jtdc.sar_tdc_energy(_j(b.numpy()), 8, _j(VDD)))
    _close(ttdc.sar_tdc_latency(b, _t(VDD)),
           jtdc.sar_tdc_latency(_j(b.numpy()), _j(VDD)))
    _close(ttdc.sar_tdc_area(b), jtdc.sar_tdc_area(_j(b.numpy())))
    _close(ttdc.tdc_energy_per_vmm(_t(N), bits, 3.0, 8, _t(VDD)),
           jtdc.tdc_energy_per_vmm(_j(N), bits, 3.0, 8, _j(VDD)))
    for n in (16, 100, 4096):
        assert ttdc.range_bits(ttdc.effective_range_steps(n, bits)) == \
            jtdc.range_bits(jtdc.effective_range_steps(n, bits))


@pytest.mark.parametrize("bits", [1, 4, 8])
@pytest.mark.parametrize("lib", ["default", "ff"])
def test_analog_functions(bits, lib):
    jl, tl = _libs()[lib]
    sig = rng.uniform(0.1, 4.0, 64).astype(np.float32)
    got = tanalog.analog_energy_per_mac(_t(N), bits, _t(sig), 8, _t(VDD),
                                       p_x_one=_t(P1),
                                       w_bit_sparsity=_t(WSP), lib=tl)
    want = janalog.analog_energy_per_mac(_j(N), bits, _j(sig), 8, _j(VDD),
                                         p_x_one=_j(P1),
                                         w_bit_sparsity=_j(WSP), lib=jl)
    np.testing.assert_array_equal(got["r"].numpy(), np.asarray(want["r"]))
    for k in ("e_mac", "e_cap", "e_adc", "enob"):
        _close(got[k], want[k])
    _close(tanalog.analog_throughput(_t(N), bits, _t(sig), lib=tl),
           janalog.analog_throughput(_j(N), bits, _j(sig), lib=jl))
    _close(tanalog.analog_area(_t(N), bits, _t(sig), lib=tl),
           janalog.analog_area(_j(N), bits, _j(sig), lib=jl))


@pytest.mark.parametrize("bits", [1, 4, 8])
@pytest.mark.parametrize("lib", ["default", "ss"])
def test_digital_functions(bits, lib):
    jl, tl = _libs()[lib]
    _close(tdigital.digital_energy_per_mac(_t(N), bits, _t(VDD), _t(P1),
                                           _t(WSP), tl),
           jdigital.digital_energy_per_mac(_j(N), bits, _j(VDD), _j(P1),
                                           _j(WSP), jl))
    _close(tdigital.digital_throughput(_t(N), bits, 8, tl),
           jdigital.digital_throughput(_j(N), bits, 8, jl))
    _close(tdigital.digital_area(_t(N), bits, tl),
           jdigital.digital_area(_j(N), bits, jl))
    for n in (16, 100, 4096):
        assert tdigital.digital_energy_per_mac(n, bits, lib=tl) == \
            jdigital.digital_energy_per_mac(n, bits, lib=jl)


# ---------------------------------------------------------------------------
# the golden fixture
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def golden():
    with open(FIXTURE) as f:
        doc = json.load(f)
    assert tuple(doc["ns"]) == NS and tuple(doc["bits"]) == BITS
    points, winners = {}, {}
    for r in doc["records"]:
        k = (r["regime"], r["n"], r["bits"])
        if r["domain"] == "__winner__":
            winners[k] = r["winner"]
        else:
            points[(r["regime"], r["domain"], r["n"], r["bits"])] = r
    return points, winners, {"exact": tds.sigma_exact(),
                             "relaxed": doc["sigma_relaxed"]}


def test_evaluate_matches_golden_fixture(golden):
    points, winners, regimes = golden
    for regime, sigma in regimes.items():
        for b in BITS:
            for n in NS:
                pts = {d: tds.evaluate(d, n, b, sigma, device="cpu")
                       for d in tds.DOMAINS}
                for d, p in pts.items():
                    ref = points[(regime, d, n, b)]
                    assert int(p.redundancy) == ref["redundancy"], (d, n, b)
                    assert int(p.aux.get("tdc_lsb_q", 1)) == ref["tdc_q"]
                    for f in ("e_mac", "throughput", "area_per_mac"):
                        np.testing.assert_allclose(
                            getattr(p, f), ref[f], rtol=1e-4,
                            err_msg=f"{regime}/{d}/n={n}/B={b}/{f}")
                assert min(pts, key=lambda d: pts[d].e_mac) == \
                    winners[(regime, n, b)], (regime, n, b)


def test_sweep_batched_matches_golden_fixture(golden):
    points, winners, regimes = golden
    for regime, sigma in regimes.items():
        g = tds.sweep_batched(ns=NS, bit_widths=BITS,
                              sigma_maxes=None if regime == "exact"
                              else sigma, device="cpu")
        names = g.winner_names()
        for bi, b in enumerate(BITS):
            for ni, n in enumerate(NS):
                for di, d in enumerate(g.domains):
                    ref = points[(regime, d, n, b)]
                    ix = (di, bi, ni, 0, 0, 0, 0, 0, 0)
                    assert g.redundancy[ix] == ref["redundancy"], (d, n, b)
                    assert g.tdc_q[ix] == ref["tdc_q"], (d, n, b)
                    for f in ("e_mac", "throughput", "area_per_mac"):
                        np.testing.assert_allclose(
                            getattr(g, f)[ix], ref[f], rtol=1e-4,
                            err_msg=f"{regime}/{d}/n={n}/B={b}/{f}")
                assert names[bi, ni, 0, 0, 0, 0, 0, 0] \
                    == winners[(regime, n, b)], (regime, n, b)


def test_size_one_wrappers_match_reference():
    for d in tds.DOMAINS:
        got = tds.evaluate(d, 300, 4, 1.5, vdd=0.6, device="cpu")
        want = jds.evaluate(d, 300, 4, 1.5, vdd=0.6)
        assert (got.domain, got.redundancy) == (want.domain,
                                                want.redundancy)
        for f in ("e_mac", "throughput", "area_per_mac"):
            np.testing.assert_allclose(getattr(got, f), getattr(want, f),
                                       rtol=1e-4)
        assert set(got.aux) == set(want.aux)
    got = tds.td_vdd_optimized(576, 4, 2.0, device="cpu")
    want = jds.td_vdd_optimized(576, 4, 2.0)
    assert (got.aux["vdd"], got.redundancy, got.aux["tdc_lsb_q"]) == \
        (want.aux["vdd"], want.redundancy, want.aux["tdc_lsb_q"])
    assert tds.best_domain(64, 2, 2.0, device="cpu").domain == \
        jds.best_domain(64, 2, 2.0).domain
    pts = tds.sweep(ns=(16, 576), bit_widths=(2, 8), device="cpu")
    ref = jds.sweep(ns=(16, 576), bit_widths=(2, 8))
    assert [(p.domain, p.n, p.bits, p.redundancy) for p in pts] == \
        [(p.domain, p.n, p.bits, p.redundancy) for p in ref]


# ---------------------------------------------------------------------------
# grid by grid against the reference engine
# ---------------------------------------------------------------------------
GRIDS = [("golden", "exact"), ("golden", "relaxed"),
         ("paper-exact", "tt"), ("paper-relaxed", "tt"), ("vdd-opt", "tt"),
         *[("edge", c) for c in CORNERS],
         *[("periphery", c) for c in CORNERS]]


@pytest.fixture(scope="module")
def grids():
    """(reference grid, port grid) per GRIDS entry, each swept once."""
    out = {}
    for name, corner in GRIDS:
        if name == "golden":
            sig = None if corner == "exact" else 2.0
            out[(name, corner)] = (
                jgrid.sweep_batched(ns=NS, bit_widths=BITS, sigma_maxes=sig),
                tgrid.sweep_batched(ns=NS, bit_widths=BITS, sigma_maxes=sig,
                                    device="cpu"))
        else:
            out[(name, corner)] = (
                jscenario.sweep_scenario(name, corner),
                tscenario.sweep_scenario(name, corner, device="cpu"))
    return out


def _assert_grids_equal(jg, tg, rtol=1e-4):
    assert jg.shape == tg.shape and jg.domains == tg.domains
    assert jg.tdc_archs == tg.tdc_archs
    for a in ("ns", "bit_widths", "sigma_maxes", "vdds", "p_x_ones",
              "w_bit_sparsities", "ms"):
        np.testing.assert_array_equal(getattr(tg, a), getattr(jg, a))
    for f in INT_FIELDS:
        np.testing.assert_array_equal(getattr(tg, f), getattr(jg, f),
                                      err_msg=f)
    for f in FLOAT_FIELDS:
        np.testing.assert_allclose(getattr(tg, f), getattr(jg, f),
                                   rtol=rtol, err_msg=f)
    for opt in ("vdd_opt", "m_opt", "tdc_arch_opt"):
        a, b = getattr(jg, opt), getattr(tg, opt)
        assert (a is None) == (b is None), opt
        if a is not None:
            np.testing.assert_array_equal(b, a, err_msg=opt)
    for metric in ("e_mac", "throughput", "area_per_mac"):
        np.testing.assert_array_equal(tg.winners(metric),
                                      jg.winners(metric))


@pytest.mark.parametrize("name,corner", GRIDS)
def test_sweep_matches_reference_engine(grids, name, corner):
    jg, tg = grids[(name, corner)]
    assert tg.redundancy.dtype == np.int64 and tg.tdc_q.dtype == np.int64
    _assert_grids_equal(jg, tg)


@pytest.mark.parametrize("name,corner", GRIDS)
def test_reductions_match_reference(grids, name, corner):
    jg, tg = grids[(name, corner)]
    for axes in (("vdd",), ("m",), ("tdc_arch",), ("vdd", "m", "tdc_arch")):
        jr, tr = jg, tg
        for ax in axes:
            jr = jscenario._REDUCERS[ax](jr)
            tr = tscenario._REDUCERS[ax](tr)
        _assert_grids_equal(jr, tr)
    np.testing.assert_array_equal(tgrid.pareto_frontier(tg),
                                  jgrid.pareto_frontier(jg))
    assert tgrid.domain_crossovers(tg) == jgrid.domain_crossovers(jg)
    for d in tg.domains:
        assert tgrid.winner_intervals(tg, d) == jgrid.winner_intervals(jg, d)


def test_concat_and_npz_round_trip(grids, tmp_path):
    jg, tg = grids[("edge", "ss")]
    path = jg.save_npz(str(tmp_path / "ref.npz"))
    loaded = tgrid.DesignGrid.load_npz(path)
    _assert_grids_equal(jg, loaded, rtol=0)
    red = jgrid.minimize_over_vdd(jg)
    loaded = tgrid.DesignGrid.load_npz(red.save_npz(str(tmp_path / "r.npz")))
    np.testing.assert_array_equal(loaded.vdd_opt, red.vdd_opt)
    lo = tscenario.sweep_scenario(
        tscenario.get_scenario("edge").replace(vdds=(0.4, 0.6)), "tt",
        device="cpu")
    hi = tscenario.sweep_scenario(
        tscenario.get_scenario("edge").replace(vdds=(0.5, 0.8)), "tt",
        device="cpu")
    merged = tgrid.concat_along_axis([lo, hi], "vdd")
    ref = jgrid.concat_along_axis(
        [jscenario.sweep_scenario(
            jscenario.get_scenario("edge").replace(vdds=v), "tt")
         for v in ((0.4, 0.6), (0.5, 0.8))], "vdd")
    _assert_grids_equal(ref, merged)


def test_optimal_td_vdds_and_evaluate_td_batched_match_reference():
    n = np.array([16, 64, 576, 1000, 4096], np.float64)
    s = np.array([0.3, 1.0, 2.0, 0.5, 4.0])
    for corner in CORNERS:
        jl = jscenario.CORNERS[corner].apply_lib()
        tl = tscenario.CORNERS[corner].apply_lib()
        np.testing.assert_array_equal(
            tscenario.optimal_td_vdds(n, s, bits=4, lib=tl, device="cpu"),
            jscenario.optimal_td_vdds(n, s, bits=4, lib=jl))
    got = tgrid.evaluate_td_batched(n, s, 0.6, bits=3, m=16, tdc_arch="sar",
                                    device="cpu")
    want = jgrid.evaluate_td_batched(n, s, 0.6, bits=3, m=16,
                                     tdc_arch="sar")
    assert set(got) == set(want)
    for k in ("redundancy", "tdc_q", "l_osc"):
        np.testing.assert_array_equal(got[k], want[k])
    for k in ("e_mac", "sigma_chain_achieved", "e_cell", "e_tdc"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4)


# ---------------------------------------------------------------------------
# the explorer service
# ---------------------------------------------------------------------------
def test_explorer_memo_hits_match_reference_stats():
    jsvc = jexplorer.ExplorerService()
    tsvc = texplorer.ExplorerService(device="cpu")
    n, s = np.array([64.0, 576.0]), np.array([2.0, 0.5])
    for svc in (jsvc, tsvc):
        a = svc.evaluate_td(n, s, bits=4)
        a["redundancy"][0] = -1                   # the caller's copy
        b = svc.evaluate_td(n, s, bits=4)
        assert b["redundancy"][0] != -1
        v1 = svc.optimal_td_vdds(n, s, bits=4)
        v1[0] = -1.0
        v2 = svc.optimal_td_vdds(n, s, bits=4)
        assert v2[0] != -1.0
        g1 = svc.sweep("paper-relaxed")
        g2, info = svc.sweep_info("paper-relaxed")
        assert g2 is g1 and info["source"] == "memory"
        svc.sweep("paper-relaxed", minimize_over=("vdd",))
    keys = ("queries", "memory_hits", "misses", "points_evaluated",
            "points_served", "td_queries", "td_hits", "vdd_opt_queries",
            "vdd_opt_hits")
    assert {k: getattr(tsvc.stats, k) for k in keys} == \
        {k: getattr(jsvc.stats, k) for k in keys}
    assert tsvc.stats.td_hits == 1 and tsvc.stats.vdd_opt_hits == 1
    np.testing.assert_array_equal(b["redundancy"],
                                  jsvc.evaluate_td(n, s, bits=4)
                                  ["redundancy"])
    assert tsvc.cache_entries == 2 and tsvc.cache_bytes > 0
    assert tsvc.stats.hit_rate == jsvc.stats.hit_rate
    grids = tsvc.sweep_scenarios("periphery", corners=("tt", "ss"))
    assert sorted(grids) == ["ss", "tt"]


def test_explorer_cache_key_differs_from_reference_and_is_stable():
    kw = dict(domains=("td",), bit_widths=(4,), ms=(8,),
              tdc_archs=("hybrid",), clip_range=True, relax_tdc=True,
              ns=(16,), sigma_maxes=(2.0,), vdds=(0.8,), p_x_ones=(0.5,),
              w_bit_sparsities=(0.7,))
    a = texplorer.grid_cache_key(lib=ttechlib.DEFAULT_LIB, **kw)
    assert a == texplorer.grid_cache_key(lib=ttechlib.DEFAULT_LIB, **kw)
    assert a != jexplorer.grid_cache_key(lib=jtechlib.DEFAULT_LIB, **kw)
    assert a != texplorer.grid_cache_key(
        lib=ttechlib.DEFAULT_LIB.at_corner(tscenario.CORNERS["ss"]), **kw)


def test_explorer_unported_options_raise_and_default_is_cuda(monkeypatch,
                                                            tmp_path):
    """The disk store, refine and the fan-out are ported (their parity is
    `tests/test_torch_explorer_store.py`): bad options raise ValueError;
    the default device is CUDA, which raises here."""
    svc = texplorer.ExplorerService(cache_dir=str(tmp_path / "store"),
                                    device="cpu")
    assert svc.cache_dir == str(tmp_path / "store")
    with pytest.raises(ValueError, match="refine"):
        svc.refine("edge", refine_axis="m")
    with pytest.raises(ValueError, match="hi > lo"):
        svc.refine("edge", lo=0.8, hi=0.8)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        texplorer.ExplorerService().sweep("paper-exact")
    with pytest.raises(RuntimeError, match="CUDA"):
        tgrid.sweep_batched(ns=(16,), bit_widths=(4,))
    prev = texplorer.set_service(None)
    try:
        assert texplorer.service().device is None
        assert texplorer.service() is texplorer.service()
    finally:
        texplorer.set_service(prev)
