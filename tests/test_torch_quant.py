"""Port parity: LSQ quantization, bit-serial helpers and the policy solve
of `repro_torch` against the JAX reference `repro`.

Inputs come from numpy with fixed seeds.  Tolerances: LSQ codes and the
bit-serial identities are bit-exact (integer results), in float32 and in
bfloat16; `init_step_size` agrees to rtol 1e-6 (a mean over the weight,
reduced in another order); the port's `solve_td_policy` (on the CPU)
equals the reference's in every integer and operating-point field, and in
sigma_chain to 1e-6 relative (the reference's compiled solve fuses
multiply-adds, the port rounds each op: an ulp apart at some keys).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.configs.base import TDExecCfg as JTDExecCfg
from repro.models import common as jcommon
from repro.quant import bitserial as jbits
from repro.quant import lsq as jlsq
from repro.tdsim import policy as jpolicy
from repro_torch.configs.base import TDExecCfg
from repro_torch.models import common as tcommon
from repro_torch.quant import bitserial as tbits
from repro_torch.quant import lsq as tlsq
from repro_torch.tdsim import policy as tpolicy

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _pair(a: np.ndarray, dt: str):
    jdt, tdt = DTYPES[dt]
    return jnp.asarray(a).astype(jdt), torch.from_numpy(a).to(tdt)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy() if x.is_floating_point() else x.numpy()
    x = jnp.asarray(x)
    return np.asarray(x.astype(jnp.float32) if jnp.issubdtype(
        x.dtype, jnp.floating) else x)


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("bits,signed", [(2, True), (4, True), (8, True),
                                         (4, False)])
def test_lsq_codes_bit_exact(dt, bits, signed):
    rng = np.random.default_rng(bits + 10 * signed)
    v = (rng.standard_normal((64, 96)) * 1.7).astype(np.float32)
    # step sizes that put many values on rounding boundaries
    for s in (0.25, 0.1337, 2.0 / 7 ** 0.5, 1e-9):
        vj, vt = _pair(v, dt)
        sj, st = _pair(np.asarray(s, np.float32), dt)
        want = np.asarray(jlsq.lsq_quantize_int(vj, sj, bits, signed))
        got = tlsq.lsq_quantize_int(vt, st, bits, signed)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(
            _np(tlsq.lsq_fake_quant(vt, st, bits, signed)),
            _np(jlsq.lsq_fake_quant(vj, sj, bits, signed)))


def test_qrange_matches():
    for bits in range(1, 9):
        for signed in (True, False):
            assert tlsq.qrange(bits, signed) == jlsq.qrange(bits, signed)


@pytest.mark.parametrize("bits", [1, 4, 8])
def test_bitserial_round_trip(bits):
    rng = np.random.default_rng(bits)
    lo = -(2 ** (bits - 1))
    x = rng.integers(lo, -lo, size=(5, 37)).astype(np.int32)
    w = rng.integers(lo, -lo, size=(37, 11)).astype(np.int32)
    xt = torch.from_numpy(x)
    xu = tbits.to_offset(xt, bits)
    assert int(xu.min()) >= 0 and int(xu.max()) < 2 ** bits
    planes = tbits.bit_planes(xu, bits)
    np.testing.assert_array_equal(
        planes.numpy(), np.asarray(jbits.bit_planes(jnp.asarray(x) + 2 ** (
            bits - 1), bits)))
    np.testing.assert_array_equal(
        tbits.recompose_planes(planes.to(torch.float32)).numpy(),
        xu.numpy().astype(np.float32))
    got = tbits.signed_matmul_via_offset(xt, torch.from_numpy(w), bits, bits)
    np.testing.assert_array_equal(got.numpy(), (x @ w).astype(np.float32))
    assert tbits.offset_of(bits) == jbits.offset_of(bits)


@pytest.mark.parametrize("bits", [2, 4, 8])
def test_init_step_size(bits):
    w = (np.random.default_rng(bits).standard_normal((256, 192))
         / 16).astype(np.float32)
    want = float(jlsq.init_step_size(jnp.asarray(w), bits, True))
    got = tlsq.init_step_size(torch.from_numpy(w), bits, True)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), want, rtol=1e-6)


# (bits_a, bits_w, n_chain, sigma_max) keys of the table of reference
# solutions the port read before its solve was ported
TABLE_KEYS = [(4, 4, 16, None), (4, 4, 16, 2.0), (4, 4, 48, None),
              (4, 4, 48, 2.0), (4, 4, 64, None), (4, 4, 64, 2.0),
              (4, 4, 576, None), (4, 4, 576, 2.0)]
_EXACT_FIELDS = ("mode", "bits_a", "bits_w", "n_chain", "redundancy", "tdc_q",
                 "m", "tdc_arch", "vdd", "p_x_one", "w_bit_sparsity",
                 "sigma_max", "techlib")


def _assert_policy_matches(got, want):
    for f in _EXACT_FIELDS:
        assert getattr(got, f) == getattr(want, f), f
    np.testing.assert_allclose(got.sigma_chain, want.sigma_chain, rtol=1e-6)


@pytest.mark.parametrize("key", TABLE_KEYS)
def test_policy_table_row_matches_reference_solve(key):
    want = jpolicy.solve_td_policy(*key)
    got = tpolicy.solve_td_policy(*key, device="cpu")
    _assert_policy_matches(got, want)


def test_default_td_policy_is_exact_regime_row():
    got = tcommon.resolve_policy(TDExecCfg(mode="td"), device="cpu")
    want = jcommon.resolve_policy(JTDExecCfg(mode="td"))
    assert (got.redundancy, got.sigma_chain, got.tdc_q, got.vdd) == (
        want.redundancy, want.sigma_chain, want.tdc_q, want.vdd)
    assert (got.redundancy, got.tdc_q) == (76, 1)
    assert got.sigma_chain == 0.16601820290088654


def test_off_table_policy_key_solves_like_reference():
    """A key the former table did not hold now solves, as the reference's
    does."""
    got = tcommon.resolve_policy(TDExecCfg(mode="td", n_chain=100),
                                 device="cpu")
    want = jcommon.resolve_policy(JTDExecCfg(mode="td", n_chain=100))
    _assert_policy_matches(got, want)


def test_policy_dataclasses_mirror_reference():
    assert [f.name for f in tpolicy.TDPolicy.__dataclass_fields__.values()] \
        == [f.name for f in jpolicy.TDPolicy.__dataclass_fields__.values()]
    for f in ("mode", "bits_a", "bits_w", "n_chain", "m", "vdd", "p_x_one",
              "w_bit_sparsity", "tdc_arch"):
        assert getattr(tpolicy.TDPolicy(), f) == getattr(jpolicy.TDPolicy(), f)
    assert tcommon.resolve_policy(TDExecCfg(mode="quant")) == \
        tpolicy.quant_policy(4, 4)
    net = tpolicy.NetworkPolicy(layers=(tpolicy.PRECISE,) * 3,
                                top=tpolicy.quant_policy())
    assert net.homogeneous and len(net) == 3
    assert tpolicy.pol_at(net, 1) is tpolicy.PRECISE
    assert tpolicy.pol_top(net).mode == "quant"
    assert tpolicy.pol_attn(net) is None
