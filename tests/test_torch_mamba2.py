"""Port parity of the mamba2 mixer (`repro_torch.models.mamba2`) against
`repro.models.mamba2`, float32, the reference under `jax.jit`, inputs
from a numpy seed, parameters from the reference's init through the
converter, on zamba2-1.2b's smoke config (d 64, d_inner 128, 8 heads of
16, d_state 16, d_conv 4, chunk 16):

* `_causal_conv` without and with a carry: output and new carry within
  1e-6;
* `_segsum`: within 1e-6 on and below the diagonal, exactly NEG_INF
  above it;
* `ssd_chunked` at S 37 (not a multiple of the chunk) and S 16, without
  and with an initial state: y and the final state within 1e-5;
* `mamba2` in its three branches (no state, a prefill into a state, a
  single step), precise and quant: output and state within 1e-5;
* the init's deterministic leaves (``dt_bias``, ``a_log``, ``d_skip``)
  within 1e-6 of the reference's, its leaf names and shapes equal, and
  `init_state`'s shapes and dtype.
"""
import torch_threads  # noqa: F401  (first: torch's threads under xdist)
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import repro.configs as jcfgs
from repro.models import mamba2 as jm
from repro.tdsim.policy import TDPolicy as JPolicy
from repro.tdsim.policy import quant_policy as jquant
import repro_torch.configs as tcfgs
from repro_torch import prng
from repro_torch.convert import tree_from_numpy
from repro_torch.models import mamba2 as tm
from repro_torch.tdsim.policy import TDPolicy as TPolicy
from repro_torch.tdsim.policy import quant_policy as tquant

NAME = "zamba2-1.2b"
B = 2


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


@pytest.mark.parametrize("carry", [False, True])
def test_causal_conv(carry):
    x, w, b = _rand(1, (B, 9, 24)), _rand(2, (4, 24)), _rand(3, (24,))
    st = _rand(4, (B, 3, 24)) if carry else None
    jy, js = jax.jit(jm._causal_conv)(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
        None if st is None else jnp.asarray(st))
    ty, ts = tm._causal_conv(torch.from_numpy(x), torch.from_numpy(w),
                             torch.from_numpy(b),
                             None if st is None else torch.from_numpy(st))
    _close(ty, jy, 1e-6, "y")
    _close(ts, js, 0.0, "carry")
    assert ts.shape == (B, 3, 24)


def test_segsum():
    a = _rand(5, (B, 3, 16), 0.3)
    want = np.asarray(jax.jit(jm._segsum)(jnp.asarray(a)))
    got = tm._segsum(torch.from_numpy(a)).numpy()
    low = np.tril(np.ones((16, 16), bool))
    _close(got[..., low], want[..., low], 1e-6)
    assert np.all(got[..., ~low] == tm.NEG_INF)
    assert np.all(want[..., ~low] == jm.NEG_INF)


def _ssd_inputs(seed, s, h=8, p=16, n=16):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, s, h, p)).astype(np.float32)
    dt = (rng.uniform(0.001, 0.1, (B, s, h))).astype(np.float32)
    a = -np.linspace(1.0, 16.0, h).astype(np.float32)
    bm = rng.standard_normal((B, s, n)).astype(np.float32)
    cm = rng.standard_normal((B, s, n)).astype(np.float32)
    s0 = rng.standard_normal((B, h, p, n)).astype(np.float32)
    return x, dt, a, bm, cm, s0


@pytest.mark.parametrize("s", [37, 16])
@pytest.mark.parametrize("with_s0", [False, True])
def test_ssd_chunked(s, with_s0):
    x, dt, a, bm, cm, s0 = _ssd_inputs(6 + s, s)
    s0 = s0 if with_s0 else None
    jy, jst = jax.jit(lambda *t: jm.ssd_chunked(*t[:5], 16, s0=t[5]))(
        *(jnp.asarray(v) if v is not None else None
          for v in (x, dt, a, bm, cm, s0)))
    ty, tst = tm.ssd_chunked(*(torch.from_numpy(v) for v in
                               (x, dt, a, bm, cm)), 16,
                             s0=None if s0 is None else torch.from_numpy(s0))
    assert ty.shape == (B, s, 8, 16) and tst.shape == (B, 8, 16, 16)
    _close(ty, jy, 1e-5, "y")
    _close(tst, jst, 1e-5, "state")


@pytest.fixture(scope="module")
def params():
    jc, _ = _cfgs()
    out = {}
    for mode in ("precise", "quant"):
        jp = jm.mamba2_init(jax.random.PRNGKey(7), jc, _pols(mode)[0])
        out[mode] = (jp, tree_from_numpy(jax.device_get(jp)))
    return out


@pytest.mark.parametrize("mode", ["precise", "quant"])
@pytest.mark.parametrize("branch", ["train", "prefill", "step"])
def test_mamba2_branches(params, mode, branch):
    jc, tc = _cfgs()
    jpol, tpol = _pols(mode)
    jp, tp = params[mode]
    s = {"train": 21, "prefill": 21, "step": 1}[branch]
    u = _rand(8, (B, s, jc.d_model))
    state = None
    if branch != "train":
        state = {"conv": _rand(9, (B, 3, 128 + 32), 0.5),
                 "ssm": _rand(10, (B, 8, 16, 16), 0.5)}
    jy, jst = jax.jit(lambda p, x, st: jm.mamba2(
        p, x, jc, jpol, state=st, key=jax.random.key(3)))(
            jp, jnp.asarray(u),
            None if state is None else jax.tree_util.tree_map(jnp.asarray,
                                                              state))
    ty, tst = tm.mamba2(tp, torch.from_numpy(u), tc, tpol,
                        state=None if state is None else
                        tree_from_numpy(state), key=prng.key(3))
    _close(ty, jy, 1e-5, "y")
    if state is None:
        assert jst is None and tst is None
    else:
        assert sorted(tst) == sorted(jst) == ["conv", "ssm"]
        assert tst["ssm"].dtype == torch.float32
        for k in ("conv", "ssm"):
            _close(tst[k], jst[k], 1e-5, k)


def test_init_leaves_and_state():
    jc, tc = _cfgs()
    jp = jm.mamba2_init(jax.random.PRNGKey(0), jc, jquant())
    tp = tm.mamba2_init(torch.Generator().manual_seed(0), tc, tquant())
    jl = {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
          for path, v in jax.tree_util.tree_leaves_with_path(jp)}
    tl = {"/".join(path): v for path, v in _leaves(tp)}
    assert sorted(tl) == sorted(jl)
    for name in jl:
        assert tuple(tl[name].shape) == jl[name].shape, name
    for name in ("dt_bias", "a_log", "d_skip", "conv_b", "norm/scale"):
        _close(tl[name], jl[name], 1e-6, name)
    st = tm.init_state(3, tc, device="cpu")
    jst = jm.init_state(3, jc)
    for k in ("conv", "ssm"):
        assert tuple(st[k].shape) == jst[k].shape
        assert st[k].dtype == torch.float32 and not st[k].any()


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    else:
        yield path, tree
