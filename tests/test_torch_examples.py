"""The four port-side examples (`examples/*_torch.py`) on the CPU at their
smallest sizes, against the reference where it computes the same thing.

* quickstart: the design points (fJ/MAC, MAC/s, um^2/MAC to rtol 1e-4;
  R exactly), the winner, the solved policy's R and TDC q, and the
  per-layer search and policies equal the reference's functions at the
  same arguments.
* hw_design_explorer: csv and json of a small grid equal the reference
  example's for the same arguments (integers and strings exactly, floats
  to rtol 1e-4); a scenario with a corner and `--minimize-vdd` runs as a
  table into a `--cache-dir` store; `--query` reaches the port's
  explorer server.
* serve_decode: its tokens are `launch.serve.run`'s at the same settings.
* train_qat_lm `--small`: the loss falls over its steps, and a second
  session resumes from the first one's checkpoint.
"""
import torch_threads  # noqa: F401  (first: torch's threads under xdist)
import csv
import importlib.util
import json
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

import repro.core.design_space as jds
from repro.core.noise_tolerance import find_sigma_max_batched as jsearch
from repro.tdsim import solve_network_policies as jnet
from repro.tdsim import solve_td_policy as jsolve
import jax
import jax.numpy as jnp
import repro_torch.configs as tcfgs
from repro_torch.configs.base import TDExecCfg
from repro_torch.core import explorer as texplorer
from repro_torch.launch import explore as texplore
from repro_torch.launch import serve as tserve

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"


def _load(name: str):
    spec = importlib.util.spec_from_file_location(
        f"example_{name}", EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(autouse=True)
def _cpu_explorer():
    """The examples set the process-wide explorer service: restore it."""
    prev = texplorer.set_service(texplorer.ExplorerService(device="cpu"))
    yield
    texplorer.set_service(prev)


def test_quickstart_matches_reference():
    q = _load("quickstart_torch")
    out = q.main(["--device", "cpu"])
    n, b, s = q.N_CHAIN, q.BITS, q.SIGMA_MAX
    for domain in jds.DOMAINS:
        got, want = out["points"][domain], jds.evaluate(domain, n, b, s)
        for f in ("e_mac", "throughput", "area_per_mac"):
            np.testing.assert_allclose(getattr(got, f), getattr(want, f),
                                       rtol=1e-4, err_msg=f"{domain} {f}")
        assert got.redundancy == want.redundancy, domain
    assert out["winner"] == jds.best_domain(n, b, s).domain
    pol = jsolve(bits_a=4, bits_w=4, n_chain=n, sigma_max=s)
    assert (out["policy"].redundancy, out["policy"].tdc_q) == \
        (pol.redundancy, pol.tdc_q)
    np.testing.assert_allclose(float(out["policy"].sigma_chain),
                               float(pol.sigma_chain), rtol=1e-4)
    assert 0 < out["rel"] < 0.1

    frag = jnp.asarray(q.FRAGILITY)
    res = jsearch(lambda v, k: 1.0 - jnp.sum(frag * v), list(q.SIGMAS),
                  jax.random.PRNGKey(0), n_layers=3, n_repeats=2)
    np.testing.assert_allclose(out["sigma_max"], np.asarray(res.sigma_max),
                               rtol=1e-6)
    net = jnet(res.sigma_max, bits_w=b, n_chain=n)
    assert [(p.redundancy, p.tdc_q) for p in out["net"].layers] == \
        [(p.redundancy, p.tdc_q) for p in net.layers]


GRID = ["--grid", "n=16,64,576", "bits=2,4", "sigma=2.0", "vdd=0.6,0.8"]


def _read(path: Path, fmt: str) -> list:
    if fmt == "json":
        return json.loads(path.read_text())
    with path.open() as f:
        return list(csv.DictReader(f))


def _same_records(got: list, want: list) -> None:
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert list(g) == list(w)
        for k, wv in w.items():
            gv = g[k]
            try:
                wf, gf = float(wv), float(gv)
            except (TypeError, ValueError):
                assert gv == wv, k
                continue
            if float(wf).is_integer() and "." not in str(wv):
                assert gf == wf, k
            else:
                np.testing.assert_allclose(gf, wf, rtol=1e-4, err_msg=k)


@pytest.mark.parametrize("fmt", ["csv", "json"])
def test_explorer_records_match_reference_example(fmt, tmp_path,
                                                  monkeypatch):
    ours = _load("hw_design_explorer_torch")
    ref = _load("hw_design_explorer")
    ours.main([*GRID, "--format", fmt, "--out", str(tmp_path / f"t.{fmt}"),
               "--device", "cpu"])
    monkeypatch.setattr(sys, "argv", ["hw_design_explorer.py", *GRID,
                                      "--format", fmt, "--out",
                                      str(tmp_path / f"j.{fmt}")])
    ref.main()
    _same_records(_read(tmp_path / f"t.{fmt}", fmt),
                  _read(tmp_path / f"j.{fmt}", fmt))


def test_explorer_scenario_table_cache_and_query(tmp_path, capsys):
    ours = _load("hw_design_explorer_torch")
    store = tmp_path / "store"
    g = ours.main(["--scenario", "edge", "--corner", "ss", "--minimize-vdd",
                   "--cache-dir", str(store), "--device", "cpu"])
    assert np.isnan(g.vdds).all()          # the supply axis folded
    assert "winner map" in capsys.readouterr().out
    assert any(store.iterdir())
    svc = texplorer.ExplorerService(device="cpu")
    server = texplore.ExplorerServer(svc, "127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        port = server.address[1]
        assert ours.main(["--query", "ping", "--port", str(port)]) is None
        reply = json.loads(capsys.readouterr().out)
        assert reply["ok"]
    finally:
        server.shutdown()
        thread.join(timeout=10)
    assert not thread.is_alive()


def test_serve_decode_equals_serve_run():
    ex = _load("serve_decode_torch")
    args = ["--batch", "2", "--prompt-len", "8", "--gen", "4"]
    got = ex.main([*args, "--device", "cpu"])
    arch = tcfgs.get_smoke("qwen3-8b").replace(
        td=TDExecCfg(mode="td", bits_a=4, bits_w=4, n_chain=64,
                     sigma_max=2.0))
    want = tserve.run(arch, 2, 8, 4, device="cpu")
    assert got.shape == (2, 4)
    assert torch.equal(got, want)


def test_train_qat_lm_small_learns_and_resumes(tmp_path, monkeypatch):
    ex = _load("train_qat_lm_torch")
    monkeypatch.setattr(ex, "CKPT_EVERY", 2)
    args = ["--small", "--device", "cpu", "--ckpt-dir", str(tmp_path)]
    _, losses = ex.main([*args, "--steps", "4"])
    assert len(losses) == 4 and losses[-1] < losses[0], losses
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "step_00000002", "step_00000004"]
    _, more = ex.main([*args, "--steps", "6"])
    assert len(more) == 2           # steps 4 and 5, from the checkpoint
    assert np.isfinite(more).all()
