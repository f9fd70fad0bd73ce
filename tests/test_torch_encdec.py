"""Port parity of the enc-dec family's modules: the seamless-m4t-large-v2
smoke model (2 encoder + 2 decoder layers, d 64, 4 heads of 16, frames of
48) from the reference's converted init, float32 compute, the reference
under `jax.jit`.

* Cross-attention (`models.attention` with ``kv_from``), with no valid
  mask, a per-row prefix mask and one shared mask, at Sq 5 and Sq 1:
  outputs within 1e-5, no cache returned (a cache handed in is left as
  it is);
* `encode` within 1e-5 and `decode` without caches within 1e-4, at
  precise, quant and td at sigma 0;
* `prefill` + 4 greedy `decode_step`s with float32 caches: tokens
  identical to the reference's, logits within 1e-4; in precise mode the
  decode logits also equal `decode` over the whole sequence without
  caches (teacher forcing) within 1e-4;
* noisy td (the solved policy's sigma): the noise's moments (the mean
  and std of noisy minus clean encoder output) within 10% of the
  reference's;
* `matmul_shapes` equal to the reference's ledger, shape for shape;
* the converter's checks and round trip (every leaf bit for bit, the
  reference's leaf names), and a checkpoint of the enc-dec parameters
  and optimizer state with the reference's leaf names and digests;
* the scheduler refuses the family, as the reference's does.
"""
import torch_threads  # noqa: F401  (first: torch's threads under xdist)
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import repro.configs as jcfgs
from repro.checkpoint import ckpt as jckpt
from repro.launch.scheduler import ContinuousBatchingEngine as JEngine
from repro.models import attention as jattn
from repro.models import encdec as jencdec
from repro.models import get_api as jget_api
from repro.models import matmul_shapes as jshapes
from repro.optim import adamw as jadamw
from repro.tdsim.policy import TDPolicy as JPolicy
from repro.tdsim.policy import quant_policy as jquant
import repro_torch.configs as tcfgs
from repro_torch import prng
from repro_torch.checkpoint import ckpt
from repro_torch.convert import params_from_jax, tree_from_numpy
from repro_torch.launch.scheduler import ContinuousBatchingEngine as TEngine
from repro_torch.models import attention as tattn
from repro_torch.models import encdec as tencdec
from repro_torch.models import get_api as tget_api
from repro_torch.models import matmul_shapes as tshapes
from repro_torch.optim import adamw as tadamw
from repro_torch.tdsim.policy import TDPolicy as TPolicy
from repro_torch.tdsim.policy import quant_policy as tquant

NAME = "seamless-m4t-large-v2"
B, FRAMES = 2, 6


@pytest.fixture(scope="module")
def params():
    cfg = jcfgs.get_smoke(NAME).model
    jp = jget_api(cfg)["init"](jax.random.key(0), cfg, jquant())
    return jp, params_from_jax(jax.device_get(jp), cfg, device="cpu")


def _cfgs():
    return jcfgs.get_smoke(NAME).model, tcfgs.get_smoke(NAME).model


def _pols(mode, sigma=0.0):
    if mode == "quant":
        return jquant(), tquant()
    if mode == "precise":
        return JPolicy(), TPolicy()
    return (JPolicy(mode="td", n_chain=48, sigma_chain=sigma),
            TPolicy(mode="td", n_chain=48, sigma_chain=sigma))


def _embeds(seed=5, b=B, frames=FRAMES):
    return np.random.default_rng(seed).standard_normal(
        (b, frames, 48)).astype(np.float32)


def _tokens(seed=6, b=B, s=5):
    return np.random.default_rng(seed).integers(0, 128, (b, s)).astype(
        np.int32)


@pytest.mark.parametrize("sq", [5, 1])
@pytest.mark.parametrize("valid", ["none", "rows", "shared"])
def test_cross_attention_matches_reference(valid, sq):
    """``kv_from`` 9 encoder positions; ``causal`` is passed as True at
    Sq 5 (cross-attention never masks causally) and False at Sq 1, where a
    KV cache is also handed in and left alone."""
    jc, tc = _cfgs()
    jp = jattn.attn_init(jax.random.PRNGKey(3), jc, jquant(), cross=True)
    tp = tree_from_numpy(jax.device_get(jp))
    rng = np.random.default_rng(4)
    x = rng.standard_normal((B, sq, jc.d_model)).astype(np.float32)
    mem = rng.standard_normal((B, 9, jc.d_model)).astype(np.float32)
    mask = {"none": None,
            "rows": np.arange(9)[None] < np.array([[9], [4]]),
            "shared": np.arange(9) < 6}[valid]
    pos = np.arange(3, 3 + sq, dtype=np.int32)
    causal = sq > 1
    jcache = None if causal else jattn.init_cache(B, 8, jc)
    tcache = None if causal else tattn.init_cache(B, 8, tc, device="cpu")
    yj, nj = jattn.attention(
        jp, jnp.asarray(x), jc, jquant(), jnp.asarray(pos), cache=jcache,
        kv_from=jnp.asarray(mem),
        kv_from_valid=None if mask is None else jnp.asarray(mask),
        causal=causal, key=jax.random.key(2))
    yt, nt = tattn.attention(
        tp, torch.from_numpy(x), tc, tquant(), torch.from_numpy(pos),
        cache=tcache, kv_from=torch.from_numpy(mem),
        kv_from_valid=None if mask is None else torch.from_numpy(mask),
        causal=causal, key=prng.key(2))
    assert nj is None and nt is None
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=0,
                               atol=1e-5)
    if tcache is not None:
        assert tcache["idx"] == 0 and not tcache["k"].any()


def test_cross_blocks_have_no_qk_norm():
    """A cross-attention block has no q/k norms, also under qk-norm."""
    jc, tc = (jcfgs.get_smoke("qwen3-8b").model,
              tcfgs.get_smoke("qwen3-8b").model)
    gen = torch.Generator().manual_seed(0)
    for cross in (False, True):
        jkeys = sorted(jattn.attn_init(jax.random.PRNGKey(0), jc, jquant(),
                                       cross=cross))
        tkeys = sorted(tattn.attn_init(gen, tc, tquant(), device="cpu",
                                       cross=cross))
        assert tkeys == jkeys
        assert ("q_norm" in tkeys) != cross


@pytest.mark.parametrize("mode", ["precise", "quant", "td0"])
def test_encode_and_decode_match_reference(params, mode):
    jc, tc = _cfgs()
    jpol, tpol = _pols(mode)
    jp, tp = params
    emb, toks = _embeds(), _tokens()
    jenc = jax.jit(lambda p, e: jencdec.encode(
        p, e, jc, jpol, key=jax.random.key(3)))(jp, jnp.asarray(emb))
    jlog, jcaches = jax.jit(lambda p, t, e: jencdec.decode(
        p, t, e, jc, jpol, key=jax.random.key(3)))(
            jp, jnp.asarray(toks), jenc)
    with torch.no_grad():
        tenc = tencdec.encode(tp, torch.from_numpy(emb), tc, tpol,
                              key=prng.key(3))
        tlog, tcaches = tencdec.decode(tp, torch.from_numpy(toks), tenc, tc,
                                       tpol, key=prng.key(3))
    assert jcaches is None and tcaches is None
    assert tenc.shape == (B, FRAMES, tc.d_model)
    np.testing.assert_allclose(tenc.numpy(), np.asarray(jenc), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), rtol=0,
                               atol=1e-4)


@pytest.mark.parametrize("mode", ["precise", "quant", "td0"])
def test_prefill_and_decode_steps_match_reference(params, mode):
    jc, tc = _cfgs()
    jpol, tpol = _pols(mode)
    jp, tp = params
    prompt, gen = 5, 5
    emb, toks = _embeds(7), _tokens(8, s=prompt)
    japi, tapi = jget_api(jc), tget_api(tc)
    jl, js = jax.jit(lambda p, b: japi["prefill"](
        p, b, jc, jpol, s_cache=prompt + gen, cache_dtype=jnp.float32))(
            jp, {"tokens": jnp.asarray(toks), "embeds": jnp.asarray(emb)})
    jdec = jax.jit(lambda p, t, s: japi["decode_step"](p, t, s, jc, jpol))
    with torch.no_grad():
        tl, ts = tapi["prefill"](
            tp, {"tokens": torch.from_numpy(toks),
                 "embeds": torch.from_numpy(emb)}, tc, tpol,
            s_cache=prompt + gen, cache_dtype=torch.float32)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                                   atol=1e-4)
        np.testing.assert_allclose(ts["enc_out"].numpy(),
                                   np.asarray(js["enc_out"]), rtol=0,
                                   atol=1e-5)
        jt = jnp.argmax(jl[:, -1], -1).astype(jnp.int32)[:, None]
        tt = torch.argmax(tl[:, -1], -1).to(torch.int32)[:, None]
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
        seq, steps = [tt], [tl[:, -1]]
        for _ in range(gen - 1):
            jlog, js = jdec(jp, jt, js)
            tlog, ts = tapi["decode_step"](tp, tt, ts, tc, tpol)
            jt = jnp.argmax(jlog, -1).astype(jnp.int32)[:, None]
            tt = torch.argmax(tlog, -1).to(torch.int32)[:, None]
            np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
            np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog),
                                       rtol=0, atol=1e-4)
            seq.append(tt)
            steps.append(tlog)
        assert ts["layers"][0]["self"]["idx"] == prompt + gen - 1
        assert int(js["layers"][0]["self"]["idx"]) == prompt + gen - 1
        if mode == "precise":
            full = torch.cat([torch.from_numpy(toks)] + seq[:-1], 1)
            tf, _ = tencdec.decode(tp, full, ts["enc_out"], tc, tpol)
            np.testing.assert_allclose(torch.stack(steps, 1).numpy(),
                                       tf[:, prompt - 1:].numpy(), rtol=0,
                                       atol=1e-4)


def test_noisy_encode_moments_match_reference(params):
    """td at a noisy sigma: Box-Muller draws are not bit-reproducible
    across backends, so the noise (noisy minus sigma-0 encoder output,
    over 4 keys) is held to the reference's by its mean and std."""
    jc, tc = _cfgs()
    jp, tp = params
    emb = _embeds(9, b=4, frames=8)
    diffs = {"j": [], "t": []}
    for sigma in (0.0, 1.5):
        jpol, tpol = _pols("td", sigma)
        jenc = jax.jit(lambda p, e, k: jencdec.encode(p, e, jc, jpol,
                                                      key=k))
        for seed in range(4):
            j = np.asarray(jenc(jp, jnp.asarray(emb), jax.random.key(seed)))
            with torch.no_grad():
                t = tencdec.encode(tp, torch.from_numpy(emb), tc, tpol,
                                   key=prng.key(seed)).numpy()
            if sigma == 0.0:
                diffs["j"].append(-j)
                diffs["t"].append(-t)
            else:
                diffs["j"][seed] += j
                diffs["t"][seed] += t
    dj, dt = np.stack(diffs["j"]), np.stack(diffs["t"])
    assert dj.std() > 1e-3
    np.testing.assert_allclose(dt.std(), dj.std(), rtol=0.1)
    assert abs(dt.mean() - dj.mean()) <= 0.1 * dj.std()


@pytest.mark.parametrize("full", [False, True])
def test_matmul_shapes_match_reference(full):
    get = (lambda c: c.get(NAME)) if full else (lambda c: c.get_smoke(NAME))
    want = [dataclasses.astuple(s) for s in jshapes(get(jcfgs).model)]
    got = [dataclasses.astuple(s) for s in tshapes(get(tcfgs).model)]
    assert got == want
    names = [s[0] for s in got]
    assert names[-4:] == ["enc.attn", "enc.mlp", "dec.xattn", "lm_head"]


def test_converter_checks_and_round_trip(params):
    """Every leaf equal bit for bit under the reference's leaf names;
    trees with a layer missing, or a decoder layer without its
    cross-attention, are refused."""
    jp, tp = params
    cfg = tcfgs.get_smoke(NAME).model
    names, vals, _ = jckpt._flatten(jp)
    tnames, tvals = ckpt._flatten(tp)
    assert tnames == names
    for n, a, b in zip(names, vals, tvals):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a), err_msg=n)
    host = jax.device_get(jp)
    short = {**host, "encoder": host["encoder"][:1]}
    with pytest.raises(ValueError, match="'encoder'"):
        params_from_jax(short, cfg, device="cpu")
    no_x = {**host, "decoder": [{k: v for k, v in lp.items()
                                  if k != "xattn"} for lp in host["decoder"]]}
    with pytest.raises(ValueError, match="xattn"):
        params_from_jax(no_x, cfg, device="cpu")


def test_checkpoint_round_trip_of_the_encdec_tree(params, tmp_path):
    """(params, AdamW state) of the enc-dec model: the manifest's leaf
    names, shapes, dtypes and digests equal the reference's for the same
    tree, and the restore gives back every leaf."""
    jp, tp = params
    jtree = (jp, jadamw.init_opt_state(jp))
    ttree = (tp, tadamw.init_opt_state(tp))
    ckpt.save(str(tmp_path), 3, ttree, async_write=False,
              meta={"arch": NAME})
    names, vals, _ = jckpt._flatten(jtree)
    host = [np.asarray(v) for v in vals]
    step, back, meta = ckpt.restore(str(tmp_path), ttree)
    assert step == 3 and meta["arch"] == NAME
    got_names, got = ckpt._flatten(back)
    assert got_names == names
    assert any("decoder/0/xattn/wk/w" in n for n in names)
    for n, want, b in zip(names, host, got):
        assert list(b.shape) == list(want.shape), n
        assert ckpt._digest(b.numpy()) == jckpt._digest(want), n


def test_scheduler_refuses_the_family():
    """Both packages' engines refuse an enc-dec model before any work."""
    for engine, cfgs in ((JEngine, jcfgs), (TEngine, tcfgs)):
        with pytest.raises(ValueError, match="decoder-family"):
            engine(cfgs.get_smoke(NAME))
