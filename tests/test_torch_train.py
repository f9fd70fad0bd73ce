"""Port parity of the training slice's pieces against the JAX reference:
threefry keys and noise seeds, the synthetic data stream, AdamW, the td
matmul's straight-through backward, the flash-attention recompute
backward, remat, and the train driver.

Tolerances: keys, seeds and data are bit-exact; `lr_schedule` agrees to
rtol 1e-6 (float32 cos and pow of each library); one and two AdamW updates
agree to rtol 1e-6 / atol 1e-9 in float32; td_matmul's gradients (the
fake-quant matmul's, f32 products summed in another order) to rtol 1e-5 /
atol 1e-6, and its noisy forward as `tests/test_torch_td_vmm.py` holds it
(rare TDC flips of one step); flash attention's gradients, chunked or
not (the einsums run at other shapes), to rtol 1e-5 / atol 1e-6; remat
"full", "dots" and "none" give bit-identical port results; the train
loop's float32 losses (`launch.train.run`) agree to rtol 1e-5 with the
reference's.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro.configs.base import ShapeCfg as JShape
from repro.configs.base import TrainCfg as JTrain
from repro.data.pipeline import PrefetchLoader as JLoader
from repro.data.synthetic import DataCfg as JDataCfg
from repro.data.synthetic import SyntheticStream as JStream
from repro.kernels.flash_attn import ops as jflash
from repro.kernels.td_vmm import ref as jtd_ref
from repro.launch import train as jtrain
from repro.models import common as jcommon
from repro.optim import adamw as jadamw
from repro.tdsim import td_linear as jlin
from repro.tdsim.policy import TDPolicy as JPolicy
from repro_torch import prng
from repro_torch.checkpoint import ckpt
from repro_torch.configs.base import ShapeCfg as TShape
from repro_torch.configs.base import TrainCfg as TTrain
from repro_torch.data.pipeline import PrefetchLoader as TLoader
from repro_torch.data.synthetic import DataCfg as TDataCfg
from repro_torch.data.synthetic import SyntheticStream as TStream
from repro_torch.kernels.flash_attn import ops as tflash
from repro_torch.kernels.td_vmm import ref as ttd_ref
from repro_torch.launch import steps as tsteps
from repro_torch.launch import train as ttrain
from repro_torch.models import common as tcommon
from repro_torch.optim import adamw as tadamw
from repro_torch.tdsim import td_linear as tlin
from repro_torch.tdsim.policy import solve_td_policy

from torch_train_parity import archs, init_pair

INDICES = (0, 1, 2, 3, 7, 63, 10_000, 123_456_789, 2 ** 31, 2 ** 32 - 1)


def _words(k) -> tuple[int, int]:
    return tuple(int(v) for v in np.asarray(jax.random.key_data(k)))


# ---------------------------------------------------------------------------
# keys and seeds
# ---------------------------------------------------------------------------
def test_threefry_keys_and_seeds_bit_exact():
    """key(seed), fold_in over many indices, nested folds along the
    model's key tree, and the derived noise seeds."""
    for seed in list(range(40)) + [1000, 2 ** 31 - 1, 2 ** 32 - 1]:
        jk = jax.random.key(np.uint32(seed))
        tk = prng.key(seed)
        assert _words(jk) == tk
        for i in INDICES:
            assert _words(jax.random.fold_in(jk, i)) == prng.fold_in(tk, i)
        # per microbatch, per layer (2i, 2i+1), per dense, lm_head
        for path in ((1, 2, 0), (3, 5, 4), (0, 10_000), (7, 1, 2)):
            jn = jcommon.fold_key(jk, *path)
            tn = tcommon.fold_key(tk, *path)
            assert _words(jn) == tn
            assert int(jtd_ref.derive_seed(jn)) == ttd_ref.derive_seed(tn)
    assert tcommon.fold_key(None, 3) is None
    with pytest.raises(ValueError):
        prng.key(-1)


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------
def test_synthetic_stream_and_loader_equal_reference():
    kw = dict(vocab=128, seq_len=48, global_batch=4, seed=3)
    js, ts = JStream(JDataCfg(**kw)), TStream(TDataCfg(**kw))
    for step in range(4):
        jb, tb = js.batch(step), ts.batch(step)
        assert sorted(jb) == sorted(tb) == ["labels", "tokens"]
        for k in jb:
            np.testing.assert_array_equal(tb[k], jb[k])
    np.testing.assert_array_equal(ts.frontend_batch(2, 4, 8),
                                  js.frontend_batch(2, 4, 8))
    jl, tl = JLoader(js, start_step=5), TLoader(ts, start_step=5)
    try:
        for _ in range(2):
            (ji, jb), (ti, tb) = jl.get(), tl.get()
            assert ji == ti
            np.testing.assert_array_equal(tb["tokens"], jb["tokens"])
    finally:
        jl.close()
        tl.close()


# ---------------------------------------------------------------------------
# optimizer
# ---------------------------------------------------------------------------
def test_lr_schedule_matches_reference():
    cfg_j, cfg_t = JTrain(warmup=10, total_steps=50), TTrain(warmup=10,
                                                             total_steps=50)
    for step in (0, 1, 5, 10, 11, 30, 50, 51, 90):
        want = float(jadamw.lr_schedule(jnp.int32(step), cfg_j))
        got = float(tadamw.lr_schedule(torch.tensor(step, dtype=torch.int32),
                                       cfg_t))
        np.testing.assert_allclose(got, want, rtol=1e-6)


def _opt_tree(rng):
    """Decayed leaves (w, table) and skipped ones (scale, s_a, s_w, bias)."""
    def r(*shape):
        return np.asarray(rng.standard_normal(shape) * 0.5, np.float32)
    return {"embed": {"table": r(6, 4)},
            "layers": [{"attn": {"wq": {"w": r(4, 3), "s_a": r(),
                                        "s_w": r()}},
                        "ln1": {"scale": r(4)}},
                       {"mlp": {"wi": {"w": r(4, 5), "b": r(5)}},
                        "norm": {"bias": r(4)}}]}


def test_apply_updates_matches_reference():
    rng = np.random.default_rng(0)
    params = _opt_tree(rng)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    tp = tadamw.tree_map(lambda a: torch.from_numpy(a).clone(), params)
    cfg_j = JTrain(warmup=2, total_steps=10, weight_decay=0.1, grad_clip=0.5)
    cfg_t = TTrain(warmup=2, total_steps=10, weight_decay=0.1, grad_clip=0.5)
    jo, to = jadamw.init_opt_state(jp), tadamw.init_opt_state(tp)
    for _ in range(2):
        grads = _opt_tree(rng)
        jp, jo, jm = jadamw.apply_updates(
            jp, jax.tree_util.tree_map(jnp.asarray, grads), jo, cfg_j)
        tp, to, tm = tadamw.apply_updates(
            tp, tadamw.tree_map(torch.from_numpy, grads), to, cfg_t)
        for k in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-6)
    assert int(to.step) == int(jo.step) == 2
    for jt, tt in ((jp, tp), (jo.mu, to.mu), (jo.nu, to.nu)):
        jl = jax.tree_util.tree_leaves_with_path(jt)
        tl = tadamw.tree_leaves_with_path(tt)
        assert [p for p, _ in tl] == ["/".join(str(getattr(
            k, "key", getattr(k, "idx", k))) for k in kp) for kp, _ in jl]
        for (_, a), (_, b) in zip(jl, tl):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6,
                                       atol=1e-9)
    assert not tadamw._is_decay_param("layers/0/attn/wq/s_w")
    assert tadamw._is_decay_param("layers/0/attn/wq/w")


# ---------------------------------------------------------------------------
# straight-through backward and flash backward
# ---------------------------------------------------------------------------
def _solved_pair(n_chain):
    tpol = solve_td_policy(4, 4, n_chain, device="cpu")
    jpol = JPolicy(mode="td", n_chain=n_chain, redundancy=tpol.redundancy,
                   sigma_chain=tpol.sigma_chain, tdc_q=tpol.tdc_q)
    return jpol, tpol


@pytest.mark.parametrize("n_chain", [48, 64])
def test_td_matmul_ste_gradients_match_reference(n_chain):
    """td mode with noise, the reference's Pallas kernel in interpret
    mode: gradients of sum(y * cot) w.r.t. x, w, s_a, s_w."""
    rng = np.random.default_rng(n_chain)
    x = rng.standard_normal((2, 5, 100)).astype(np.float32)
    w = (rng.standard_normal((100, 12)) * 0.1).astype(np.float32)
    cot = rng.standard_normal((2, 5, 12)).astype(np.float32)
    s_a, s_w = np.float32(0.7559289), np.float32(0.035)
    jpol, tpol = _solved_pair(n_chain)
    jkey = jax.random.fold_in(jax.random.key(np.uint32(3)), 7)
    tkey = prng.fold_in(prng.key(3), 7)

    def jloss(a, b, c, d):
        y = jlin.td_matmul(a, b, c, d, jpol, jkey)
        return jnp.sum(y * cot), y

    (_, jy), jg = jax.value_and_grad(jloss, argnums=(0, 1, 2, 3),
                                     has_aux=True)(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(s_a), jnp.asarray(s_w))
    ts = [torch.tensor(v).requires_grad_() for v in (x, w, s_a, s_w)]
    ty = tlin.td_matmul(*ts, tpol, tkey)
    (ty * torch.from_numpy(cot)).sum().backward()
    step = float(s_a * s_w)
    diff = ty.detach().numpy() - np.asarray(jy)
    assert (diff != 0).mean() <= 0.01
    np.testing.assert_allclose(np.round(diff / step), diff / step, atol=1e-3)
    for a, b in zip(jg, ts):
        assert b.grad.shape == a.shape
        np.testing.assert_allclose(b.grad.numpy(), np.asarray(a), rtol=1e-5,
                                   atol=1e-6)


def _attn_inputs(rng, b, sq, skv, hq, hkv, d):
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((b, sq, hq, d), (b, skv, hkv, d), (b, skv, hkv, d),
                      (b, sq, hq, d))]


@pytest.mark.parametrize("sq,skv,offset,kv_len", [(24, 24, 0, (24, 9)),
                                                  (8, 24, 16, (24, 20))])
def test_flash_attention_gradients_match_reference(sq, skv, offset, kv_len):
    rng = np.random.default_rng(sq)
    q, k, v, cot = _attn_inputs(rng, 2, sq, skv, 4, 2, 16)
    lens = np.asarray(kv_len, np.int32)

    def jloss(a, b, c):
        return jnp.sum(jflash.flash_attention(
            a, b, c, jnp.asarray(lens), jnp.int32(offset)) * cot)

    jg = jax.grad(jloss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    ts = [torch.tensor(t).requires_grad_() for t in (q, k, v)]
    out = tflash.flash_attention(*ts, torch.from_numpy(lens),
                                 torch.tensor([offset], dtype=torch.int32))
    (out * torch.from_numpy(cot)).sum().backward()
    for a, b in zip(jg, ts):
        np.testing.assert_allclose(b.grad.numpy(), np.asarray(a), rtol=1e-5,
                                   atol=1e-6)


def test_chunked_recompute_matches_unchunked_and_reference():
    """The q-chunked branch (cap 8 over 24 query rows: three chunks with
    their own causal offsets) against the one-chunk recompute of both
    packages."""
    assert tflash._q_chunk(24, 8) == 8 and tflash._q_chunk(24) == 24
    assert tflash._q_chunk(7, 4) == 1
    rng = np.random.default_rng(1)
    q, k, v, cot = _attn_inputs(rng, 2, 24, 24, 4, 2, 16)
    lens = np.asarray([24, 13], np.int32)
    off = np.asarray([3], np.int32)

    def jloss(a, b, c):
        return jnp.sum(jflash._attn_recompute(
            True, a, b, c, jnp.asarray(lens), jnp.int32(3)) * cot)

    jg = jax.grad(jloss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    grads = []
    for cap in (8, 512):
        ts = [torch.tensor(t).requires_grad_() for t in (q, k, v)]
        o = tflash._attn_recompute(True, *ts, torch.from_numpy(lens),
                                   torch.from_numpy(off), cap=cap)
        (o * torch.from_numpy(cot)).sum().backward()
        grads.append([t.grad.numpy() for t in ts])
    for a, b, c in zip(jg, *grads):
        np.testing.assert_allclose(b, c, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(b, np.asarray(a), rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# remat and the driver
# ---------------------------------------------------------------------------
def test_remat_full_equals_none():
    results = []
    for remat in ("full", "none", "dots"):
        _, ta = archs("qwen3-8b", "td", "float32", remat=remat)
        _, tp = init_pair(archs("qwen3-8b", "td", "float32")[0])
        to = tadamw.init_opt_state(tp)
        step = tsteps.build_train_step(ta, TShape("t", 16, 4, "train"),
                                       device="cpu")
        batch = TStream(TDataCfg(vocab=128, seq_len=16, global_batch=4,
                                 seed=0)).batch(0)
        tp, to, m = step(tp, to, {k: torch.from_numpy(v)
                                  for k, v in batch.items()}, 0)
        results.append((float(m["loss"]), float(m["grad_norm"]),
                        [p.clone() for _, p in
                         tadamw.tree_leaves_with_path(tp)]))
    # "full" and "dots" against "none"
    for other in (results[0], results[2]):
        assert other[:2] == results[1][:2]
        for a, b in zip(other[2], results[1][2]):
            assert torch.equal(a, b)


def test_train_run_matches_reference_driver(monkeypatch, capsys, tmp_path):
    """Both drivers, 3 steps of the qwen3-8b smoke model in td mode at
    float32 compute from the reference's init; the port's CLI on the CPU,
    also at a scenario and corner and with --td-attn and --ckpt-dir."""
    ja, ta = archs("qwen3-8b", "td", "float32", n_micro=1)
    jp, tp = init_pair(ja)
    monkeypatch.setattr(jtrain, "get_api", lambda cfg: {
        "init": lambda *a, **k: jp})
    monkeypatch.setattr(ttrain, "get_api", lambda cfg: {
        "init": lambda *a, **k: tp})
    _, jl = jtrain.run(ja, JShape("t", 16, 4, "train"), 3, None)
    stats: dict = {}
    _, tl = ttrain.run(ta, TShape("t", 16, 4, "train"), 3, None,
                       device="cpu", stats=stats)
    assert np.all(np.isfinite(tl)) and len(tl) == 3
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    assert len(stats["step_s"]) == len(stats["grad_norm"]) == 3
    monkeypatch.undo()
    losses = ttrain.main(["--smoke", "--arch", "qwen3-8b", "--td", "td",
                          "--steps", "2", "--seq", "16", "--batch", "4",
                          "--device", "cpu"])
    assert len(losses) == 2 and np.all(np.isfinite(losses))
    assert "[train] done." in capsys.readouterr().out
    losses = ttrain.main(["--smoke", "--arch", "qwen3-8b", "--td", "td",
                          "--scenario", "edge", "--corner", "ss",
                          "--steps", "1", "--seq", "16", "--batch", "4",
                          "--device", "cpu"])
    assert len(losses) == 1 and np.all(np.isfinite(losses))
    losses = ttrain.main(["--smoke", "--device", "cpu", "--ckpt-dir",
                          str(tmp_path), "--steps", "1", "--seq", "16",
                          "--batch", "4"])
    assert len(losses) == 1 and np.all(np.isfinite(losses))
    losses = ttrain.main(["--smoke", "--arch", "qwen3-8b", "--td", "td",
                          "--td-attn", "td", "--steps", "1", "--seq", "16",
                          "--batch", "4", "--device", "cpu"])
    assert len(losses) == 1 and np.all(np.isfinite(losses))
    _, losses = ttrain.run(ta, TShape("t", 16, 4, "train"), 1,
                           str(tmp_path), ckpt_every=1, device="cpu")
    assert len(losses) == 1 and ckpt.latest_steps(str(tmp_path)) == [1]
