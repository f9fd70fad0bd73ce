"""Port parity of the stacked scan-over-layers layout (``scan_layers``):
the port of `tests/test_scan_layers.py` and of
`tests/test_network_policies.py:156-170`, against the reference's scan.
The reference's stacked trees are converted (`params_from_jax(pol=)`),
inputs come from a numpy seed, compute is float32.

* The train loss of the port's scan equals the reference's scan within
  2e-4 (granite-8b, dbrx-132b, rwkv6-1.6b smoke, precise), and the
  gradients of the embedding table and ``layers.attn.wq.w[0]`` at atol
  2e-4, rtol 2e-3 (granite-8b).
* Decoding under scan (qwen3-8b smoke, float32 stacked caches): the
  prefill's and five decode steps' logits within 1e-4 of the
  reference's, the stacked K/V leaves too.
* td mode: every td dense's seed is ``derive_seed`` of the reference's
  scan fold path ``(i, 0, j)`` / ``(i, 1, j)``, bit for bit, lm_head's of
  ``(10_000,)``; the noise (noisy minus sigma-0 logits over 4 keys)
  agrees with the reference's by its mean and std.
* A heterogeneous `NetworkPolicy` on a scan config keeps list params
  and caches in both packages; prefill and one decode agree.
* The stacked init is the unrolled init stacked, bit for bit, on every
  homogeneous family; `init_caches(pol=)` stacks exactly when the
  reference does; the converter refuses the wrong layout.
* Checkpoint manifest names, shapes, dtypes and sha256 digests of a
  stacked tree equal the reference's `_flatten` / `_digest`, and the
  tree restores bit for bit.
* `param_specs` and `cache_specs` of stacked trees equal the reference's
  PartitionSpecs as tuples.
* The continuous-batching engine: the reference's fails on a scan
  config (its insert step indexes the stacked layer axis, ROADMAP §3);
  the port's serves it, tokens equal to the reference's unrolled
  engine's (quant mode: the seeds do not enter).
* `python -m repro_torch.launch.dryrun --smoke --scan-layers` counts the
  unscanned cell's FLOPs and collective bytes.
* One 4-rank gloo run (`tests/torch_mesh_worker.py DIR 4 scan`): the
  stacked smoke model served on a (2, 2) mesh against the unsharded
  serve, and a stacked checkpoint restored onto placements.
"""
import torch_threads  # noqa: F401  (first: torch's threads under xdist)
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import repro.configs as jcfgs
from repro.checkpoint import ckpt as jckpt
from repro.configs.base import TDExecCfg as JTD
from repro.configs.base import TrainCfg as JTrain
from repro.kernels.td_vmm import ref as jref
from repro.launch import scheduler as jsched
from repro.launch import sharding as jsl
from repro.launch import specs as jspecs
from repro.models import common as jcommon
from repro.models import get_api as jget_api
from repro.models import transformer as jtr
from repro.tdsim.policy import PRECISE as JPRECISE
from repro.tdsim.policy import TDPolicy as JPolicy
from repro.tdsim.policy import quant_policy as jquant
import repro_torch.configs as tcfgs
from repro_torch import prng
from repro_torch.checkpoint import ckpt
from repro_torch.configs.base import TDExecCfg as TTD
from repro_torch.configs.base import TrainCfg as TTrain
from repro_torch.convert import params_from_jax
from repro_torch.kernels.td_vmm import ref as tref
from repro_torch.launch import scheduler as tsched
from repro_torch.launch import sharding as tsl
from repro_torch.launch import specs as tspecs
from repro_torch.models import common as tcommon
from repro_torch.models import get_api as tget_api
from repro_torch.models import transformer as ttr
from repro_torch.tdsim import td_linear
from repro_torch.tdsim.policy import PRECISE as TPRECISE
from repro_torch.tdsim.policy import TDPolicy as TPolicy
from repro_torch.tdsim.policy import quant_policy as tquant

ROOT = Path(__file__).resolve().parents[1]


def _scan(cfg):
    return dataclasses.replace(cfg, scan_layers=True)


def _models(name: str, jpol=JPRECISE, tpol=TPRECISE, scan: bool = True):
    """(reference cfg, port cfg, reference params, port params) of the
    smoke model, the reference's init converted."""
    jc = jcfgs.get_smoke(name).model
    tc = tcfgs.get_smoke(name).model
    if scan:
        jc, tc = _scan(jc), _scan(tc)
    jp = jget_api(jc)["init"](jax.random.key(0), jc, jpol)
    tp = params_from_jax(jax.device_get(jp), tc, device="cpu", pol=tpol)
    return jc, tc, jp, tp


def _batch(seed: int, cfg, b: int = 2, s: int = 16) -> dict:
    rng = np.random.default_rng(seed)
    return {k: rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)
            for k in ("tokens", "labels")}


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items()
                for k2, v2 in _flat(v, f"{prefix}{k}/").items()}
    if isinstance(tree, list):
        return {k2: v2 for i, v in enumerate(tree)
                for k2, v2 in _flat(v, f"{prefix}{i}/").items()}
    return {prefix[:-1]: tree}


@pytest.mark.parametrize("name", ["granite-8b", "dbrx-132b", "rwkv6-1.6b"])
def test_scan_loss_matches_reference_scan(name):
    jc, tc, jp, tp = _models(name)
    assert isinstance(jp["layers"], dict) and isinstance(tp["layers"], dict)
    batch = _batch(1, tc)
    jl, _ = jget_api(jc)["train_loss"](
        jp, {k: jnp.asarray(v) for k, v in batch.items()}, jc, JPRECISE,
        jax.random.key(0))
    with torch.no_grad():
        tl, _ = tget_api(tc)["train_loss"](
            tp, {k: torch.from_numpy(v) for k, v in batch.items()}, tc,
            TPRECISE, prng.key(0))
    assert abs(float(tl) - float(jl)) < 2e-4, (float(tl), float(jl))


def test_scan_gradients_match_reference_scan():
    jc, tc, jp, tp = _models("granite-8b")
    batch = _batch(2, tc, s=8)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jg = jax.grad(lambda p: jget_api(jc)["train_loss"](
        p, jb, jc, JPRECISE, jax.random.key(0))[0])(jp)
    for t in (tp["embed"]["table"], tp["layers"]["attn"]["wq"]["w"]):
        t.requires_grad_(True)
    loss, _ = tget_api(tc)["train_loss"](
        tp, {k: torch.from_numpy(v) for k, v in batch.items()}, tc,
        TPRECISE, prng.key(0))
    loss.backward()
    np.testing.assert_allclose(tp["embed"]["table"].grad.numpy(),
                               np.asarray(jg["embed"]["table"]),
                               atol=2e-4, rtol=2e-3)
    np.testing.assert_allclose(tp["layers"]["attn"]["wq"]["w"].grad[0].numpy(),
                               np.asarray(jg["layers"]["attn"]["wq"]["w"])[0],
                               atol=2e-4, rtol=2e-3)


def test_scan_decode_matches_reference_scan():
    jc, tc, jp, tp = _models("qwen3-8b")
    toks = np.random.default_rng(3).integers(0, tc.vocab, (2, 12)).astype(
        np.int32)
    japi, tapi = jget_api(jc), tget_api(tc)
    jl, js = japi["prefill"](jp, {"tokens": jnp.asarray(toks[:, :6])}, jc,
                             JPRECISE, s_cache=12, cache_dtype=jnp.float32)
    with torch.no_grad():
        tl, ts = tapi["prefill"](tp, {"tokens": torch.from_numpy(
            toks[:, :6])}, tc, TPRECISE, s_cache=12,
            cache_dtype=torch.float32)
        assert isinstance(ts["layers"], dict) and ts["layers"]["idx"] == 6
        errs = [float(np.abs(tl.numpy() - np.asarray(jl)).max())]
        for t in range(6, 11):
            jo, js = japi["decode_step"](jp, jnp.asarray(toks[:, t:t + 1]),
                                         js, jc, JPRECISE)
            to, ts = tapi["decode_step"](tp, torch.from_numpy(
                toks[:, t:t + 1]), ts, tc, TPRECISE)
            errs.append(float(np.abs(to.numpy() - np.asarray(jo)).max()))
    assert max(errs) < 1e-4, errs
    # the reference's (L,) fill index: every layer's equals the port's one
    assert np.asarray(js["layers"]["idx"]).tolist() == [11] * tc.n_layers
    assert ts["layers"]["idx"] == 11
    for leaf in ("k", "v"):
        assert tuple(ts["layers"][leaf].shape) == js["layers"][leaf].shape
        np.testing.assert_allclose(ts["layers"][leaf].numpy(),
                                   np.asarray(js["layers"][leaf]),
                                   rtol=0, atol=1e-4)


def test_td_scan_seeds_are_the_reference_fold_paths(monkeypatch):
    """Every td dense of a scanned forward draws ``derive_seed`` of the
    reference scan body's key path, bit for bit."""
    tc = _scan(tcfgs.get_smoke("qwen3-8b").model)
    pol = TPolicy(mode="td", n_chain=64, sigma_chain=1.0)
    tp = ttr.init_params(0, tc, pol, device="cpu")
    seen = []
    linear = td_linear.linear

    def record(p, x, pol_, key=None):
        seen.append(tref.derive_seed(key))
        return linear(p, x, pol_, key)
    monkeypatch.setattr(td_linear, "linear", record)
    toks = torch.from_numpy(_batch(4, tc, s=8)["tokens"])
    with torch.no_grad():
        ttr.forward(tp, {"tokens": toks}, tc, pol, key=prng.key(7))
    key = jax.random.key(7)

    def jseed(*path):
        k = key
        for i in path:
            k = jax.random.fold_in(k, i)
        return int(jref.derive_seed(k))
    want = [jseed(i, part, j) for i in range(tc.n_layers)
            for part, n in ((0, 4), (1, 3)) for j in range(n)]
    want.append(jseed(10_000))
    assert seen == want
    # the unrolled forward folds (2i, j) and (2i + 1, j): other seeds
    assert jseed(0, 1, 0) != jseed(1, 0)


def test_td_scan_noise_moments_match_reference_scan():
    """td at sigma 1.5 on the scanned qwen3-8b smoke model: the noise
    (noisy minus sigma-0 logits, over 4 keys) held to the reference's by
    its mean and std (Box-Muller draws are not bit-reproducible across
    backends)."""
    jc, tc, jp, tp = _models("qwen3-8b", jquant(), tquant())
    toks = _batch(5, tc, s=9)["tokens"]

    jitted = {}

    def pair(sigma, seed):
        jpol = JPolicy(mode="td", n_chain=64, sigma_chain=sigma)
        tpol = TPolicy(mode="td", n_chain=64, sigma_chain=sigma)
        if sigma not in jitted:
            jitted[sigma] = jax.jit(lambda p, t, k: jtr.forward(
                p, {"tokens": t}, jc, jpol, key=k)[0])
        jl = jitted[sigma](jp, jnp.asarray(toks), jax.random.key(seed))
        with torch.no_grad():
            tl = ttr.forward(tp, {"tokens": torch.from_numpy(toks)}, tc,
                             tpol, key=prng.key(seed))[0]
        return tl.numpy(), np.asarray(jl)
    clean = pair(0.0, 0)
    np.testing.assert_allclose(clean[0], clean[1], rtol=0, atol=1e-4)
    dt, dj = [], []
    for seed in range(4):
        t, j = pair(1.5, seed)
        dt.append(t - clean[0])
        dj.append(j - clean[1])
    dt, dj = np.stack(dt), np.stack(dj)
    assert dj.std() > 1e-3
    np.testing.assert_allclose(dt.std(), dj.std(), rtol=0.1)
    assert abs(dt.mean() - dj.mean()) <= 0.1 * dj.std()


def test_heterogeneous_policy_keeps_the_unrolled_layout():
    """The reference's `test_heterogeneous_with_scan_layers_cfg`, with a
    quant / precise mix (no solve): list params and caches, prefill and
    one decode equal to the reference's."""
    ja = jcfgs.get_smoke("granite-8b")
    ta = tcfgs.get_smoke("granite-8b")
    mix_j = (JTD(mode="quant"), JTD(mode="precise"))
    mix_t = (TTD(mode="quant"), TTD(mode="precise"))
    ja = ja.replace(model=_scan(ja.model), td=JTD(mode="quant"),
                    td_per_layer=mix_j)
    ta = ta.replace(model=_scan(ta.model), td=TTD(mode="quant"),
                    td_per_layer=mix_t)
    jpol = jcommon.resolve_arch_policy(ja)
    tpol = tcommon.resolve_arch_policy(ta, device="cpu")
    assert not tpol.homogeneous and not ttr._can_scan(ta.model, tpol)
    jc, tc = ja.model, ta.model
    jp = jget_api(jc)["init"](jax.random.key(0), jc, jpol)
    assert isinstance(jp["layers"], list)
    tp = params_from_jax(jax.device_get(jp), tc, device="cpu", pol=tpol)
    assert isinstance(tp["layers"], list)
    assert isinstance(ttr.init_params(0, tc, tpol, device="cpu")["layers"],
                      list)
    assert isinstance(ttr.init_caches(2, 12, tc, device="cpu", pol=tpol),
                      list)
    toks = _batch(6, tc, s=8)["tokens"]
    jl, js = jget_api(jc)["prefill"](jp, {"tokens": jnp.asarray(toks)}, jc,
                                     jpol, s_cache=12,
                                     cache_dtype=jnp.float32)
    with torch.no_grad():
        tl, ts = tget_api(tc)["prefill"](
            tp, {"tokens": torch.from_numpy(toks)}, tc, tpol, s_cache=12,
            cache_dtype=torch.float32)
    assert isinstance(ts["layers"], list)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=1e-4)
    tok = np.asarray(jnp.argmax(jl[:, -1], -1)).astype(np.int32)[:, None]
    jo, _ = jget_api(jc)["decode_step"](jp, jnp.asarray(tok), js, jc, jpol)
    with torch.no_grad():
        to, ts = tget_api(tc)["decode_step"](tp, torch.from_numpy(tok), ts,
                                             tc, tpol)
    assert isinstance(ts["layers"], list) and to.shape[-1] == tc.vocab
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=0, atol=1e-4)


@pytest.mark.parametrize("name", ["qwen3-8b", "granite-moe-1b-a400m",
                                  "rwkv6-1.6b"])
def test_stacked_init_is_the_unrolled_init_stacked(name):
    tc = tcfgs.get_smoke(name).model
    pol = tquant()
    loop = ttr.init_params(0, tc, pol, device="cpu")
    scan = ttr.init_params(0, _scan(tc), pol, device="cpu")
    want = _flat(ttr._stack_layers(loop["layers"]))
    got = _flat(scan["layers"])
    assert list(got) == list(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    for k in loop:
        if k != "layers":
            assert _flat(loop[k]).keys() == _flat(scan[k]).keys()
    # caches: stacked exactly when the reference stacks them
    jc = _scan(jcfgs.get_smoke(name).model)
    jcache = jtr.init_caches(2, 8, jc, jnp.float32, pol=jquant())
    tcache = ttr.init_caches(2, 8, _scan(tc), torch.float32, device="cpu",
                             pol=pol)
    assert isinstance(jcache, dict) and isinstance(tcache, dict)
    jf, tf = _flat(jcache), _flat(tcache)
    assert sorted(tf) == sorted(jf)
    for k, v in jf.items():
        if k != "idx":
            assert tuple(tf[k].shape) == v.shape, k
    assert isinstance(ttr.init_caches(2, 8, tc, device="cpu", pol=pol), list)


def test_converter_refuses_the_wrong_layout():
    jc, tc, jp, _ = _models("qwen3-8b")
    host = jax.device_get(jp)
    with pytest.raises(ValueError, match="list of"):
        params_from_jax(host, dataclasses.replace(tc, scan_layers=False),
                        device="cpu")
    per_layer = [jax.tree_util.tree_map(lambda a: a[i], host["layers"])
                 for i in range(tc.n_layers)]
    with pytest.raises(ValueError, match="stacked layout"):
        params_from_jax({**host, "layers": per_layer}, tc, device="cpu")
    short = jax.tree_util.tree_map(lambda a: a[:1], host["layers"])
    with pytest.raises(ValueError, match="leading axis"):
        params_from_jax({**host, "layers": short}, tc, device="cpu")
    broken = dict(host["layers"])
    del broken["mlp"]
    with pytest.raises(ValueError, match="layer 0 has"):
        params_from_jax({**host, "layers": broken}, tc, device="cpu")


def test_stacked_checkpoint_matches_reference_manifest(tmp_path):
    _, tc, jp, tp = _models("granite-moe-1b-a400m", jquant(), tquant())
    names, vals, _ = jckpt._flatten(jp)
    ckpt.save(str(tmp_path), 5, tp, async_write=False)
    man = json.loads((tmp_path / "step_00000005" / "manifest.json")
                     .read_text())
    host = [np.asarray(v) for v in vals]
    assert man["names"] == names
    assert "layers/moe/wi" in names
    assert man["shapes"] == [list(a.shape) for a in host]
    assert man["dtypes"] == [str(a.dtype) for a in host]
    assert man["digests"] == [jckpt._digest(a) for a in host]
    step, back, _ = ckpt.restore(str(tmp_path), tp, device="cpu")
    assert step == 5 and isinstance(back["layers"], dict)
    for k, v in _flat(tp).items():
        assert torch.equal(_flat(back)[k], v), k


class FakeMesh:
    def __init__(self, shape: tuple, axes: tuple):
        self.axis_names = axes
        self.shape = dict(zip(axes, shape))


MESHES = [FakeMesh((16, 16), ("data", "model")),
          FakeMesh((2, 16, 16), ("pod", "data", "model")),
          FakeMesh((2, 4), ("data", "model"))]


def _jspecs(tree) -> dict:
    flat = jax.tree_util.tree_leaves_with_path(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in kp): tuple(v) for kp, v in flat}


def _tspecs(tree) -> dict:
    out = {}
    tsl.map_with_path(lambda p, s: out.__setitem__(p, s), tree)
    return out


@pytest.mark.parametrize("name", ["qwen3-8b", "granite-moe-1b-a400m",
                                  "rwkv6-1.6b", "dbrx-132b"])
def test_stacked_specs_match_reference(name):
    """`param_specs` (serving on and off) and `cache_specs` of the full
    config's stacked trees, on three meshes, as tuples."""
    ja = jcfgs.get(name)
    ja = ja.replace(model=_scan(ja.model))
    ta = tcfgs.get(name)
    ta = ta.replace(model=_scan(ta.model))
    jparams = jax.eval_shape(lambda: jget_api(ja.model)["init"](
        jax.random.key(0), ja.model, JPRECISE))
    with tspecs.fake_mode():
        tparams = tget_api(ta.model)["init"](0, ta.model, TPRECISE,
                                             device="cpu")
    assert isinstance(tparams["layers"], dict)
    shape = tcfgs.SHAPES["decode_32k"]
    jstate = jspecs.decode_state_shapes(ja, jcfgs.SHAPES["decode_32k"])
    tstate = tspecs.decode_state_shapes(ta, shape)
    assert isinstance(tstate["layers"], dict)
    for mesh in MESHES:
        for serving in (False, True):
            assert _tspecs(tsl.param_specs(tparams, mesh, serving)) == \
                _jspecs(jsl.param_specs(jparams, mesh, serving))
        assert _tspecs(tsl.cache_specs(tstate, mesh)) == \
            _jspecs(jsl.cache_specs(jstate, mesh))


def _engine_archs():
    ja = jcfgs.get_smoke("qwen3-8b")
    ta = tcfgs.get_smoke("qwen3-8b")
    ja = ja.replace(td=JTD(mode="quant", n_chain=64),
                    train=JTrain(compute_dtype="float32"))
    ta = ta.replace(td=TTD(mode="quant", n_chain=64),
                    train=TTrain(compute_dtype="float32"))
    return ja, ta


def _reqs(mod):
    rng = np.random.default_rng(11)
    return [mod.Request(rid=i, prompt=rng.integers(3, 50, size=p).astype(
        np.int32), max_new_tokens=g)
        for i, (p, g) in enumerate([(3, 5), (7, 4), (5, 6), (4, 2)])]


def test_engine_serves_the_stacked_layout_where_the_reference_fails():
    ja, ta = _engine_archs()
    jc = ja.model
    jp = jget_api(jc)["init"](jax.random.key(0), jc, jquant())
    jscan = ja.replace(model=_scan(jc))
    jps = jget_api(jscan.model)["init"](jax.random.key(0), jscan.model,
                                        jquant())
    jeng = jsched.ContinuousBatchingEngine(jscan, capacity=3, s_cache=16,
                                           params=jps, kv_block=8)
    with pytest.raises(ValueError, match="slice indices"):
        jeng.run(_reqs(jsched))
    # the reference's unrolled engine is the yardstick
    jloop = jsched.ContinuousBatchingEngine(ja, capacity=3, s_cache=16,
                                            params=jp, kv_block=8)
    jloop.run(_reqs(jsched))
    tscan = ta.replace(model=_scan(ta.model))
    tp = params_from_jax(jax.device_get(jps), tscan.model, device="cpu")
    teng = tsched.ContinuousBatchingEngine(tscan, capacity=3, s_cache=16,
                                           params=tp, kv_block=8,
                                           device="cpu")
    assert isinstance(teng._state["layers"], dict)
    out = teng.run(_reqs(tsched))
    assert out["requests"] == 4
    assert list(teng.done) == list(jloop.done)
    assert teng.steps_run == jloop.steps_run
    for rid, req in jloop.done.items():
        assert teng.done[rid].generated == req.generated, rid


def _dryruns(out: Path, *arg_sets) -> list:
    """The smoke rwkv6-1.6b train cell on a (2, 2) mesh, one process an
    argument set, all at once; each run's JSON and file name."""
    env = dict(os.environ, REPRO_DRYRUN_DEVICES="4", OMP_NUM_THREADS="1",
               PYTHONPATH=str(ROOT / "src"))
    procs = [subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--mesh", "small",
         "--smoke", "--arch", "rwkv6-1.6b", "--shape", "train_4k", "--out",
         str(out / str(i)), *args], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, cwd=ROOT)
        for i, args in enumerate(arg_sets)]
    docs = []
    for i, p in enumerate(procs):
        log = p.communicate(timeout=300)[0]
        assert p.returncode == 0, log
        (path,) = (out / str(i)).glob("*.json")
        docs.append(json.loads(path.read_text()) | {"file": path.name})
    return docs


def test_dryrun_scan_layers_counts_the_unscanned_work(tmp_path):
    """The same FLOPs and collective bytes by kind (the stacked weights'
    gradients are reduced in fewer, larger collectives: the counts may
    differ)."""
    plain, scan = _dryruns(tmp_path, [],
                           ["--scan-layers", "--include-skips"])
    assert scan["file"].endswith("__smoke__scan.json")
    assert scan["scan_layers"] and not plain["scan_layers"]
    assert scan["flops_per_chip"] == plain["flops_per_chip"]
    assert scan["collectives"]["link_bytes"] == \
        plain["collectives"]["link_bytes"]
    assert scan["model_flops"] == plain["model_flops"]


def test_four_ranks_stacked_serve_and_restore(tmp_path):
    env = dict(os.environ, OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, str(ROOT / "tests" /
                                              "torch_mesh_worker.py"),
                          str(tmp_path), "4", "scan"], env=env,
                         capture_output=True, text=True, timeout=240,
                         cwd=ROOT)
    assert out.returncode == 0, out.stdout + out.stderr
    for r in range(4):
        doc = json.loads((tmp_path / f"rank{r}.json").read_text())
        assert doc["stacked"], r
        assert doc["serve_close"], (r, doc["serve_max_err"])
        assert doc["tokens_equal"] and doc["layouts_equal"], r
        assert doc["restore_equal"] and doc["restore_placed"], r
