"""Port parity of the RWKV-6 time and channel mix
(`repro_torch.models.rwkv6`) against `repro.models.rwkv6`, float32, the
reference under `jax.jit`, inputs from a numpy seed, parameters from the
reference's init through the converter, on rwkv6-1.6b's smoke config (d
64, 4 heads of 16, d_ff 160, mix LoRA 8, decay LoRA 8):

* `_token_shift` in its three cases (no carry, a carry at S > 1, S = 1):
  equal;
* `_ddlerp`: the five mixes within 1e-6;
* `wkv6_scan` without and with an initial state: y and the final state
  within 1e-5;
* `timemix` in its three branches (no state, a prefill into a state, a
  single step) and `chanmix` without and with a carry, precise and quant:
  output and state within 1e-5;
* the inits' leaf names and shapes equal to the reference's, their
  constant leaves equal, and `init_state`'s shapes and dtype.
"""
import torch_threads  # noqa: F401  (first: torch's threads under xdist)
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import repro.configs as jcfgs
from repro.models import rwkv6 as jr
from repro.tdsim.policy import TDPolicy as JPolicy
from repro.tdsim.policy import quant_policy as jquant
import repro_torch.configs as tcfgs
from repro_torch import prng
from repro_torch.convert import tree_from_numpy
from repro_torch.models import rwkv6 as tr
from repro_torch.tdsim.policy import TDPolicy as TPolicy
from repro_torch.tdsim.policy import quant_policy as tquant

NAME = "rwkv6-1.6b"
B, D = 2, 64


def _cfgs():
    return jcfgs.get_smoke(NAME).model, tcfgs.get_smoke(NAME).model


def _pols(mode):
    return (jquant(), tquant()) if mode == "quant" else (JPolicy(), TPolicy())


def _rand(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _close(got, want, atol, name=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0,
                               atol=atol, err_msg=name)


@pytest.mark.parametrize("case", ["none", "carry", "step"])
def test_token_shift(case):
    s = 1 if case == "step" else 7
    x = _rand(1, (B, s, D))
    last = None if case == "none" else _rand(2, (B, 1, D))
    want = jr._token_shift(jnp.asarray(x),
                           None if last is None else jnp.asarray(last))
    got = tr._token_shift(torch.from_numpy(x),
                          None if last is None else torch.from_numpy(last))
    assert tuple(got.shape) == (B, s, D)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.fixture(scope="module")
def params():
    jc, _ = _cfgs()
    out = {}
    for mode in ("precise", "quant"):
        pol = _pols(mode)[0]
        jt = jr.timemix_init(jax.random.PRNGKey(5), jc, pol)
        jcm = jr.chanmix_init(jax.random.PRNGKey(6), jc, pol)
        out[mode] = ((jt, tree_from_numpy(jax.device_get(jt))),
                     (jcm, tree_from_numpy(jax.device_get(jcm))))
    return out


def test_ddlerp(params):
    (jp, tp), _ = params["precise"]
    x, xx = _rand(3, (B, 9, D)), _rand(4, (B, 9, D))
    # a nonzero dynamic mix: the init's LoRA is tiny
    jp = {**jp, "mix_w1": jp["mix_w1"] * 50.0}
    tp = {**tp, "mix_w1": torch.from_numpy(np.array(jp["mix_w1"]))}
    want = jax.jit(jr._ddlerp)(jp, jnp.asarray(x), jnp.asarray(xx))
    got = tr._ddlerp(tp, torch.from_numpy(x), torch.from_numpy(xx))
    assert sorted(got) == sorted(want) == sorted(jr.MIX_NAMES)
    for m in jr.MIX_NAMES:
        _close(got[m], want[m], 1e-6, m)


@pytest.mark.parametrize("with_s0", [False, True])
def test_wkv6_scan(with_s0):
    s, h, hd = 13, 4, 16
    r, k, v = (_rand(i, (B, s, h, hd)) for i in (5, 6, 7))
    w = np.exp(-np.exp(_rand(8, (B, s, h, hd), 0.5) - 1.0)).astype(
        np.float32)
    u = _rand(9, (h, hd), 0.1)
    s0 = _rand(10, (B, h, hd, hd)) if with_s0 else None
    jy, js = jax.jit(jr.wkv6_scan)(
        *(jnp.asarray(a) for a in (r, k, v, w, u)),
        None if s0 is None else jnp.asarray(s0))
    ty, ts = tr.wkv6_scan(*(torch.from_numpy(a) for a in (r, k, v, w, u)),
                          None if s0 is None else torch.from_numpy(s0))
    assert ty.dtype == ts.dtype == torch.float32
    _close(ty, jy, 1e-5, "y")
    _close(ts, js, 1e-5, "state")


def _state():
    return {"wkv": _rand(11, (B, 4, 16, 16), 0.5),
            "shift_t": _rand(12, (B, 1, D)), "shift_c": _rand(13, (B, 1, D))}


@pytest.mark.parametrize("mode", ["precise", "quant"])
@pytest.mark.parametrize("branch", ["train", "prefill", "step"])
def test_timemix_branches(params, mode, branch):
    jc, tc = _cfgs()
    jpol, tpol = _pols(mode)
    (jp, tp), _ = params[mode]
    s = 1 if branch == "step" else 11
    x = _rand(14, (B, s, D))
    state = None if branch == "train" else _state()
    jy, jst = jax.jit(lambda p, xx, st: jr.timemix(
        p, xx, jc, jpol, state=st, key=jax.random.key(4)))(
            jp, jnp.asarray(x),
            None if state is None else jax.tree_util.tree_map(jnp.asarray,
                                                              state))
    ty, tst = tr.timemix(tp, torch.from_numpy(x), tc, tpol,
                         state=None if state is None else
                         tree_from_numpy(state), key=prng.key(4))
    _close(ty, jy, 1e-5, "y")
    if state is None:
        assert jst is None and tst is None
    else:
        assert sorted(tst) == sorted(jst) == ["shift_t", "wkv"]
        for k in tst:
            _close(tst[k], jst[k], 1e-5, k)


@pytest.mark.parametrize("mode", ["precise", "quant"])
@pytest.mark.parametrize("carry", [False, True])
def test_chanmix(params, mode, carry):
    jc, tc = _cfgs()
    jpol, tpol = _pols(mode)
    _, (jp, tp) = params[mode]
    x = _rand(15, (B, 6, D))
    state = _state() if carry else None
    jy, jst = jax.jit(lambda p, xx, st: jr.chanmix(
        p, xx, jc, jpol, state=st, key=jax.random.key(5)))(
            jp, jnp.asarray(x),
            None if state is None else jax.tree_util.tree_map(jnp.asarray,
                                                              state))
    ty, tst = tr.chanmix(tp, torch.from_numpy(x), tc, tpol,
                         state=None if state is None else
                         tree_from_numpy(state), key=prng.key(5))
    _close(ty, jy, 1e-5, "y")
    if carry:
        assert list(tst) == list(jst) == ["shift_c"]
        _close(tst["shift_c"], jst["shift_c"], 0.0)
    else:
        assert jst is None and tst is None


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    else:
        yield "/".join(path), tree


def test_init_leaves_and_state():
    jc, tc = _cfgs()
    gen = torch.Generator().manual_seed(0)
    for jinit, tinit in ((jr.timemix_init, tr.timemix_init),
                         (jr.chanmix_init, tr.chanmix_init)):
        jp = jax.device_get(jinit(jax.random.PRNGKey(0), jc, jquant()))
        tp = tinit(gen, tc, tquant())
        jl = dict(_leaves(jp))
        tl = dict(_leaves(tp))
        assert sorted(tl) == sorted(jl)
        for name, want in jl.items():
            assert tuple(tl[name].shape) == np.shape(want), name
            if name.startswith(("mu", "w0", "ln_x")):
                _close(tl[name], want, 0.0, name)
    st = tr.init_state(3, tc, device="cpu")
    jst = jr.init_state(3, jc)
    assert sorted(st) == sorted(jst)
    for k in st:
        assert tuple(st[k].shape) == jst[k].shape
        assert st[k].dtype == torch.float32 and not st[k].any()
