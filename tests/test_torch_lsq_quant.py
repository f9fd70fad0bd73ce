"""Port parity of the fused LSQ fake-quant kernel's plain version and of the
differentiable `lsq_fake_quant` against the JAX reference.

Inputs come from numpy with fixed seeds and include exact .5 ties of
x / s, step sizes below the 1e-8 floor (and 0 and negative ones), NaN and
infinities, and lengths that are not a multiple of the Pallas block.
Tolerances: the forward is bit-exact (compared bit pattern by bit
pattern, NaN included) against `repro.kernels.lsq_quant.ref` and against
`lsq_quant_pallas` run in interpret mode with bm=64, in float32 and
bfloat16; the gradient ``dv`` is bit-exact; ``ds`` (a sum over the tensor,
reduced in another order) agrees to rtol 1e-5 in float32 and to one bf16
rounding (rtol 2^-7) in bfloat16.
"""
import torch_threads  # noqa: F401  (first: torch's threads under xdist)
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro.kernels.lsq_quant import ops as jops
from repro.kernels.lsq_quant.lsq_quant import lsq_quant_pallas
from repro.kernels.lsq_quant.ref import lsq_quant_ref as jref
from repro.quant import lsq as jlsq
from repro_torch.kernels.lsq_quant import lsq_quant as tkern
from repro_torch.kernels.lsq_quant import ops as tops
from repro_torch.kernels.lsq_quant.ref import lsq_quant_ref as tref
from repro_torch.quant import lsq as tlsq

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
STEPS = (0.07, 0.25, 2.0 / 7 ** 0.5, 1e-9, 0.0, -0.5)


def _pair(a: np.ndarray, dt: str):
    jdt, tdt = DTYPES[dt]
    return jnp.asarray(a).astype(jdt), torch.from_numpy(
        np.asarray(a, np.float32)).to(tdt)


def _bits(x) -> np.ndarray:
    """Bit patterns (as unsigned ints) of a float array of either package,
    every NaN written as one canonical pattern (payloads carry no value)."""
    if isinstance(x, torch.Tensor):
        nan = torch.isnan(x).numpy()
        if x.dtype == torch.bfloat16:
            b = x.view(torch.int16).numpy().view(np.uint16).copy()
        else:
            b = x.numpy().view(np.uint32).copy()
    else:
        a = np.asarray(x)
        nan = np.isnan(a.astype(np.float32))
        b = a.view(np.uint16 if a.dtype.itemsize == 2 else np.uint32).copy()
    b[nan] = 0xFFFF if b.dtype == np.uint16 else 0xFFFFFFFF
    return b


def _inputs(n: int, s: float, seed: int) -> np.ndarray:
    """n values: a third exact ties (k + 0.5) * s, the rest normal, plus
    NaN and infinities when there is room."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(n) * 3).astype(np.float32)
    ties = (rng.integers(-20, 20, n) + 0.5) * (s if s > 0 else 0.07)
    pick = rng.random(n) < 1 / 3
    x[pick] = ties[pick].astype(np.float32)
    if n >= 8:
        x[:3] = [np.nan, np.inf, -np.inf]
    return x


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("bits,signed", [(4, True), (8, False)])
@pytest.mark.parametrize("shape", [(1000,), (37, 53), (2, 3, 64), (1,)])
def test_plain_version_bit_exact(dt, bits, signed, shape):
    qn, qp = tlsq.qrange(bits, signed)
    n = int(np.prod(shape))
    for i, s in enumerate(STEPS):
        x = _inputs(n, s, seed=n + i).reshape(shape)
        xj, xt = _pair(x, dt)
        sj, st = _pair(np.asarray(s, np.float32), dt)
        got = _bits(tref(xt, st, qn, qp))
        assert tref(xt, st, qn, qp).dtype == xt.dtype
        np.testing.assert_array_equal(got, _bits(jref(xj, sj, qn, qp)))
        pallas = lsq_quant_pallas(xj, sj, qn=float(qn), qp=float(qp), bm=64,
                                  interpret=True)
        np.testing.assert_array_equal(got, _bits(pallas))
        # the wrapper runs the plain version for CPU tensors
        np.testing.assert_array_equal(_bits(tkern.lsq_quant(xt, st, qn, qp)),
                                      got)


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_ops_entry_point(dt):
    x = _inputs(300, 0.1, seed=3).reshape(3, 100)
    xj, xt = _pair(x, dt)
    sj, st = _pair(np.asarray(0.1, np.float32), dt)
    np.testing.assert_array_equal(
        _bits(tops.lsq_quant(xt, st, 4, True)),
        _bits(jops.lsq_quant(xj, sj, 4, True, interpret=True)))


def test_wrapper_rejects_bad_operands():
    x = torch.zeros(8)
    with pytest.raises(TypeError, match="step size"):
        tkern.lsq_quant(x, torch.tensor(0.1, dtype=torch.bfloat16), -8, 7)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        tkern.lsq_quant(x.double(), torch.tensor(0.1).double(), -8, 7)
    with pytest.raises(ValueError, match="integer range"):
        tkern.lsq_quant(x, torch.tensor(0.1), -8.5, 7)
    with pytest.raises(ValueError, match="cuda or cpu"):
        tkern.lsq_quant(x.to("meta"), torch.tensor(0.1).to("meta"), -8, 7)
    n = tkern.launches
    tkern.lsq_quant(x, torch.tensor(0.1), -8, 7)
    assert tkern.launches == n


def _grads_jax(v, s, g, bits, signed):
    out, vjp = jax.vjp(lambda a, b: jlsq.lsq_fake_quant(a, b, bits, signed),
                       v, s)
    dv, ds = vjp(g)
    return out, dv, ds


def _grads_port(v, s, g, bits, signed):
    v = v.clone().requires_grad_()
    s = s.clone().requires_grad_()
    out = tlsq.lsq_fake_quant(v, s, bits, signed)
    out.backward(g)
    return out.detach(), v.grad, s.grad


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("bits,signed", [(4, True), (8, False)])
@pytest.mark.parametrize("s", [0.07, 0.31, 1e-9])
def test_fake_quant_gradients_match_reference(dt, bits, signed, s):
    rng = np.random.default_rng(bits)
    v = _inputs(64 * 63 + 8, s, seed=7)[8:].reshape(64, 63)   # finite
    g = rng.standard_normal(v.shape).astype(np.float32)
    vj, vt = _pair(v, dt)
    gj, gt = _pair(g, dt)
    sj, st = _pair(np.asarray(s, np.float32), dt)
    oj, dvj, dsj = _grads_jax(vj, sj, gj, bits, signed)
    ot, dvt, dst = _grads_port(vt, st, gt, bits, signed)
    np.testing.assert_array_equal(_bits(ot), _bits(oj))
    np.testing.assert_array_equal(_bits(dvt), _bits(dvj))
    assert dst.shape == () and dst.dtype == st.dtype
    rtol = 1e-5 if dt == "float32" else 2.0 ** -7
    np.testing.assert_allclose(float(dst), float(jnp.float32(dsj)),
                               rtol=rtol)


def test_mixed_dtypes_promote_as_the_reference():
    """bf16 v with a float32 step runs in float32, as ``v / s_`` does in
    JAX; a Python float step takes v's dtype."""
    v = _inputs(508, 0.05, seed=11)[8:]      # finite (NaN has no code)
    vj, vt = _pair(v, "bfloat16")
    sj, st = _pair(np.asarray(0.05, np.float32), "float32")
    got = tlsq.lsq_fake_quant(vt, st, 4, True)
    want = jlsq.lsq_fake_quant(vj, sj, 4, True)
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    np.testing.assert_array_equal(_bits(got), _bits(want))
    got = tlsq.lsq_fake_quant(vt, 0.05, 4, True)
    want = jlsq.lsq_fake_quant(vj, 0.05, 4, True)
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    np.testing.assert_array_equal(_bits(got), _bits(want))
    np.testing.assert_array_equal(
        tlsq.lsq_quantize_int(vt, st, 4, True).numpy(),
        np.asarray(jlsq.lsq_quantize_int(vj, sj, 4, True)))
