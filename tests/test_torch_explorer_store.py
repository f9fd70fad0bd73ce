"""Port parity of the explorer's disk store, corner fan-out and
incremental refinement (`core/explorer.py`) and the server's ``refine``
op (`launch/explore.py`), on the CPU, against `tests/test_explorer.py`'s
cases and the reference's `ExplorerService.refine`.

* the disk store: a sweep written as ``.npz`` under an atomic rename,
  read back by a second service as a disk hit, every field equal; the
  default service's store at ``REPRO_EXPLORER_CACHE_DIR``; threads
  solving through one service at once (the lock covers the store);
* `refine` on the reference tests' ``TINY`` case: bit-identical to the
  port's dense oracle at target 128; against the reference's `refine`
  (target 128 and the budget case) the evaluated axis values, levels and
  points evaluated equal, the integer fields and ``vdd_opt`` equal, the
  floats within rtol 1e-4 (the port's f32 engine against XLA's); the
  budget and its accounting; a bad axis raises;
* `sweep_scenarios(parallel=True)` equal to the serial loop, counted;
* the server's ``refine`` payload: the reference's `_refine_payload`
  keys and values on the same case, and ``--cache-dir`` reaching the
  service.
"""
import torch_threads  # noqa: F401  (first: torch's threads under xdist)
import os
import threading

import numpy as np
import pytest

from repro.core import explorer as jexplorer
from repro.core import scenario as jsc
from repro.launch import explore as jexplore
from repro_torch.core import design_grid as tgrid
from repro_torch.core import explorer as texplorer
from repro_torch.core import scenario as tsc
from repro_torch.launch import explore as texplore

# the reference tests' tiny scenario
TINY = tsc.Scenario("tiny", ns=(64, 576), bit_widths=(4,),
                    sigma_maxes=(2.0,), vdds=(0.6, 0.8))
JTINY = jsc.Scenario("tiny", ns=(64, 576), bit_widths=(4,),
                     sigma_maxes=(2.0,), vdds=(0.6, 0.8))
PARITY = dict(target=128, coarse=9, tau=0.25, max_axis_values=128)
BUDGET = dict(target=4096, coarse=9, max_axis_values=40)


@pytest.fixture()
def svc():
    return texplorer.ExplorerService(device="cpu")


def _fields_equal(a, b):
    for f in tgrid._FIELDS:
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), f)


def test_disk_round_trip_across_services(tmp_path):
    a = texplorer.ExplorerService(cache_dir=str(tmp_path), device="cpu")
    g1, i1 = a.sweep_info(TINY, "tt")
    assert i1["source"] == "computed"
    files = os.listdir(tmp_path)
    assert [f for f in files if f.endswith(".npz")] == [i1["key"] + ".npz"]
    assert not [f for f in files if ".tmp." in f]
    b = texplorer.ExplorerService(cache_dir=str(tmp_path), device="cpu")
    g2, i2 = b.sweep_info(TINY, "tt")
    assert i2["source"] == "disk" and b.stats.disk_hits == 1
    _fields_equal(g2, g1)
    g3, i3 = b.sweep_info(TINY, "tt")          # now in b's LRU
    assert i3["source"] == "memory" and g3 is g2
    assert b.stats.hit_rate == 1.0 and b.stats.misses == 0


def test_default_service_reads_the_cache_dir_env(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_EXPLORER_CACHE_DIR", str(tmp_path / "store"))
    prev = texplorer.set_service(None)
    try:
        assert texplorer.service().cache_dir == str(tmp_path / "store")
        assert os.path.isdir(tmp_path / "store")
    finally:
        texplorer.set_service(prev)
    monkeypatch.delenv("REPRO_EXPLORER_CACHE_DIR")
    prev = texplorer.set_service(None)
    try:
        assert texplorer.service().cache_dir is None
    finally:
        texplorer.set_service(prev)


def test_threads_share_the_disk_store(tmp_path):
    """A staged-rebuild thread and the serve loop solving at once: each
    key is written once, every thread reads the same numbers."""
    svc = texplorer.ExplorerService(cache_dir=str(tmp_path), device="cpu")
    out: dict = {}

    def run(i):
        out[i] = svc.sweep(TINY, ("tt", "ss")[i % 2])

    threads = [threading.Thread(target=run, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert len([f for f in os.listdir(tmp_path) if f.endswith(".npz")]) == 2
    _fields_equal(out[0], out[2])
    _fields_equal(out[1], out[3])
    fresh = texplorer.ExplorerService(cache_dir=str(tmp_path), device="cpu")
    _fields_equal(fresh.sweep(TINY, "ss"), out[1])
    assert fresh.stats.disk_hits == 1


def test_refine_parity_vs_dense_oracle(svc):
    res = svc.refine(TINY, "tt", **PARITY)
    axes = svc._corner_axes(tsc.get_scenario(TINY), tsc.get_corner("tt"))
    oracle = tgrid.minimize_over_vdd(svc.sweep_axes(
        **{**axes, "vdds": tuple(float(v) for v in res.dense_values)}))
    for f in ("e_mac", "redundancy", "tdc_q", "vdd_opt"):
        np.testing.assert_array_equal(getattr(res.grid, f),
                                      getattr(oracle, f), f)
    assert res.effective_points == (res.merged.n_points
                                    // len(res.evaluated_values)) * 128


@pytest.mark.parametrize("case", ["parity", "budget"])
def test_refine_matches_reference(svc, case):
    kw = PARITY if case == "parity" else BUDGET
    want = jexplorer.ExplorerService().refine(JTINY, "tt", **kw)
    got = svc.refine(TINY, "tt", **kw)
    np.testing.assert_array_equal(got.evaluated_values,
                                  want.evaluated_values)
    np.testing.assert_array_equal(got.dense_values, want.dense_values)
    assert (got.levels, got.points_evaluated, got.effective_points) == \
        (want.levels, want.points_evaluated, want.effective_points)
    for f in ("redundancy", "tdc_q", "vdd_opt"):
        np.testing.assert_array_equal(getattr(got.grid, f),
                                      getattr(want.grid, f), f)
    for f in ("e_mac", "throughput", "area_per_mac"):
        np.testing.assert_allclose(getattr(got.grid, f),
                                   getattr(want.grid, f), rtol=1e-4,
                                   err_msg=f)


def test_refine_budget_and_accounting(svc):
    res = svc.refine(TINY, "tt", **BUDGET)
    assert len(res.evaluated_values) <= 40
    assert res.points_evaluated == res.merged.n_points
    assert res.effective_points == (res.merged.n_points
                                    // len(res.evaluated_values)) * 4096
    assert svc.stats.refine_runs == 1
    assert svc.stats.refine_levels == res.levels


def test_refine_rejects_bad_axis(svc):
    with pytest.raises(ValueError):
        svc.refine(TINY, refine_axis="n")
    with pytest.raises(ValueError):
        svc.refine(TINY, refine_axis="m")


def test_parallel_equals_serial(svc):
    spec = TINY.replace(corners=("tt", "ff", "ss"))
    serial = svc.sweep_scenarios(spec, parallel=False)
    fan = svc.sweep_scenarios(spec, parallel=True, use_cache=False)
    assert list(fan) == ["tt", "ff", "ss"]
    for c in serial:
        _fields_equal(fan[c], serial[c])
    assert svc.stats.fanout_sweeps == 3


def test_refine_op_payload_matches_reference(tmp_path):
    req = {"op": "refine", "scenario": "edge", "corner": "tt",
           "target": 64, "coarse": 5, "max_axis_values": 16}
    want = jexplore.dispatch(jexplorer.ExplorerService(), req)
    got = texplore.dispatch(texplorer.ExplorerService(device="cpu"), req)
    assert want["ok"] and got["ok"], (want, got)
    assert sorted(got) == sorted(want)
    for k in ("refine_axis", "levels", "dense_size", "evaluated_axis_values",
              "points_evaluated", "effective_points"):
        assert got[k] == want[k], k
    if "vdd_opt" in want:
        np.testing.assert_array_equal(got["vdd_opt"], want["vdd_opt"])
    bad = texplore.dispatch(texplorer.ExplorerService(device="cpu"),
                            {"op": "refine", "scenario": "edge",
                             "refine_axis": "n"})
    assert not bad["ok"] and "ValueError" in bad["error"]


def test_cli_cache_dir_reaches_the_service(tmp_path, monkeypatch, capsys):
    """``--cache-dir`` (else ``REPRO_EXPLORER_CACHE_DIR``) is the served
    service's disk store; the server object is stubbed so that `main`
    returns instead of serving."""
    class Stub:
        def __init__(self, svc, host, port):
            self.service, self.address = svc, (host, port)

        def serve_forever(self):
            pass

    monkeypatch.setattr(texplore, "ExplorerServer", Stub)
    prev = texplorer.service() if texplorer._SERVICE else None
    try:
        texplore.main(["--device", "cpu", "--port", "0", "--cache-dir",
                       str(tmp_path / "a")])
        assert texplorer.service().cache_dir == str(tmp_path / "a")
        monkeypatch.setenv("REPRO_EXPLORER_CACHE_DIR", str(tmp_path / "b"))
        texplore.main(["--device", "cpu", "--port", "0"])
        assert texplorer.service().cache_dir == str(tmp_path / "b")
        assert "cache_dir=" in capsys.readouterr().out
    finally:
        texplorer.set_service(prev)
