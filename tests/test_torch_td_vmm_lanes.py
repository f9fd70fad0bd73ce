"""Port parity: td_vmm's lane axis (the reference's kernel under jax.vmap).

The JAX side is ``jax.vmap`` over the production `td_vmm_seeded`, whose
Pallas kernel runs in interpret mode on the CPU; the port's side is one
lane call of the wrapper, which on CPU tensors loops the plain version
over the lanes.  Tolerances:

* bit-exact: the lanes against single-lane calls (noise included), and
  every output at sigma = 0 against the vmapped reference, for a shared w
  and for a w a lane;
* noisy outputs against the vmapped reference: the criterion of
  `test_torch_td_vmm.py::test_noisy_outputs_agree_up_to_rare_tdc_flips`
  (at most 1% of entries differ, each by a multiple of tdc_q).
"""
import torch_threads  # noqa: F401  (first: torch's threads under xdist)
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro.kernels.td_vmm import ops as jops
from repro.tdsim.policy import TDPolicy as JPolicy
from repro_torch.kernels.td_vmm import ops as tops
from repro_torch.kernels.td_vmm import td_vmm as tkern
from repro_torch.tdsim import td_linear as tlin
from repro_torch.tdsim.policy import TDPolicy

SEEDS = [3, 0x9E3779B9, 77, 2 ** 32 - 1]


def _codes(rng, shape, bits):
    lo = -(2 ** (bits - 1))
    return rng.integers(lo, -lo, size=shape).astype(np.int32)


def _jax_lanes(x, w, sigma, q, seeds, n_chain, bits_a, bits_w):
    """jax.vmap over td_vmm_seeded: x (P, M, K), w (K, N) or (P, K, N)."""
    pol = JPolicy(mode="td", bits_a=bits_a, bits_w=bits_w, n_chain=n_chain)

    def lane(x_i, w_i, s, qq, sd):
        return jops.td_vmm_seeded(x_i, w_i,
                                  pol.replace(sigma_chain=s, tdc_q=qq), sd)
    return np.asarray(jax.vmap(lane, in_axes=(0, 0 if w.ndim == 3 else None,
                                              0, 0, 0))(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(sigma, jnp.float32),
        jnp.asarray(q, jnp.float32), jnp.asarray(seeds, jnp.uint32)))


def _port_lanes(x, w, sigma, q, seeds, n_chain, bits_a, bits_w):
    pol = TDPolicy(mode="td", bits_a=bits_a, bits_w=bits_w, n_chain=n_chain)
    return tops.td_vmm_lanes(
        torch.from_numpy(x), torch.from_numpy(w),
        pol, torch.tensor(sigma), torch.tensor(q, dtype=torch.float32),
        torch.tensor(seeds, dtype=torch.int64)).numpy()


# (P, M, K, N, n_chain): the block route (M > 8) and the split route
# (M <= 8), two segments with a tail
LANE_SHAPES = [(3, 10, 70, 9, 48), (4, 4, 70, 9, 48)]


@pytest.mark.parametrize("shape", LANE_SHAPES)
@pytest.mark.parametrize("per_lane_w", [False, True])
def test_lanes_at_sigma0_equal_vmapped_reference(shape, per_lane_w):
    p, m, k, n, n_chain = shape
    rng = np.random.default_rng(m + 10 * per_lane_w)
    x = _codes(rng, (p, m, k), 4)
    w = _codes(rng, (p, k, n) if per_lane_w else (k, n), 4)
    q = [1.0, 2.0, 3.0, 1.0][:p]
    seeds = SEEDS[:p]
    want = _jax_lanes(x, w, [0.0] * p, q, seeds, n_chain, 4, 4)
    got = _port_lanes(x, w, [0.0] * p, q, seeds, n_chain, 4, 4)
    assert got.shape == (p, m, n)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape", LANE_SHAPES)
def test_noisy_lanes_agree_with_vmapped_reference_up_to_tdc_flips(shape):
    p, m, k, n, n_chain = shape
    rng = np.random.default_rng(5)
    x = _codes(rng, (p, m, k), 4)
    w = _codes(rng, (k, n), 4)
    sigma = [0.7, 1.9179178476333618, 0.55, 0.0][:p]
    q = [1.0, 2.0, 6.0, 1.0][:p]
    seeds = SEEDS[:p]
    want = _jax_lanes(x, w, sigma, q, seeds, n_chain, 4, 4)
    got = _port_lanes(x, w, sigma, q, seeds, n_chain, 4, 4)
    for i in range(p):
        diff = got[i] - want[i]
        assert (diff != 0).mean() <= 0.01
        np.testing.assert_array_equal(np.mod(diff, q[i]), 0)
        if sigma[i] > 0:
            assert (got[i] != x[i] @ w).mean() > 0.05


@pytest.mark.parametrize("shape", LANE_SHAPES)
@pytest.mark.parametrize("bits", [(4, 4), (8, 8)])
def test_lane_call_equals_single_lane_calls(shape, bits):
    """Noise included: a lane keeps its own noise index over its own M."""
    p, m, k, n, n_chain = shape
    bits_a, bits_w = bits
    rng = np.random.default_rng(11)
    x = torch.from_numpy(_codes(rng, (p, m, k), bits_a))
    w = torch.from_numpy(_codes(rng, (p, k, n), bits_w))
    params = torch.tensor([[0.9, 1.0], [1.3, 2.0], [0.0, 1.0],
                           [2.5, 3.0]][:p])
    seed = torch.tensor(SEEDS[:p], dtype=torch.int64)
    kw = dict(bits_a=bits_a, bits_w=bits_w, n_chain=n_chain)
    got = tkern.td_vmm(x, w, params, seed, **kw)
    plan = tkern.td_vmm_plan(m, k, n, n_chain, bits_a)
    split = tkern.td_vmm_split_plain(x, w, params, seed, plan=plan, **kw)
    for i in range(p):
        one = tkern.td_vmm(x[i], w[i], params[i], seed[i:i + 1], **kw)
        assert torch.equal(got[i], one)
        assert torch.equal(split[i], one)


def test_td_matmul_lanes_equals_single_td_matmuls():
    """The lane matmul (quantize, one launch, dequantize) against one
    `td_matmul` a lane at that lane's sigma, tdc_q and seed."""
    rng = np.random.default_rng(2)
    p, k, n = 3, 60, 7
    x = torch.from_numpy(rng.standard_normal((p, 2, 5, k)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((k, n)).astype(np.float32)
                         * 0.2)
    s_a, s_w = torch.tensor(0.4), torch.tensor(0.05)
    pol = TDPolicy(mode="td", bits_a=4, bits_w=4, n_chain=48)
    sigma = torch.tensor([0.0, 1.2, 2.5])
    tdc_q = torch.tensor([1.0, 2.0, 1.0])
    keys = [(0, 1), (2, 3), (4, 5)]
    from repro_torch.kernels.td_vmm import ref as tref
    seeds = torch.tensor([tref.derive_seed(kk) for kk in keys])
    got = tlin.td_matmul_lanes(x, w, s_a, s_w, pol, sigma, tdc_q, seeds)
    assert got.shape == (p, 2, 5, n)
    for i in range(p):
        pol_i = pol.replace(sigma_chain=float(sigma[i]),
                            tdc_q=int(tdc_q[i]))
        one = tlin.td_matmul(x[i], w, s_a, s_w, pol_i, keys[i])
        assert torch.equal(got[i], one.detach())
    params = {"w": w, "s_a": s_a, "s_w": s_w, "b": torch.ones(n)}
    np.testing.assert_array_equal(
        tlin.linear_lanes(params, x, pol, sigma, tdc_q, seeds).numpy(),
        (got + 1.0).numpy())
    # other modes share one product across the lanes
    quant = pol.replace(mode="quant")
    np.testing.assert_array_equal(
        tlin.linear_lanes(params, x, quant, sigma, tdc_q, seeds).detach()
        .numpy(), tlin.linear(params, x, quant).detach().numpy())


def test_wrapper_rejects_bad_lane_operands():
    x = torch.zeros((2, 3, 8), dtype=torch.int32)
    w = torch.zeros((8, 4), dtype=torch.int32)
    par = torch.zeros((2, 2))
    seed = torch.zeros(2, dtype=torch.int64)
    kw = dict(bits_a=4, bits_w=4, n_chain=8)
    assert tkern.td_vmm(x, w, par, seed, **kw).shape == (2, 3, 4)
    with pytest.raises(TypeError):              # one params pair for 2 lanes
        tkern.td_vmm(x, w, par[0], seed, **kw)
    with pytest.raises(TypeError):              # one seed for 2 lanes
        tkern.td_vmm(x, w, par, seed[:1], **kw)
    with pytest.raises(ValueError):             # w with 3 lanes for 2
        tkern.td_vmm(x, torch.zeros((3, 8, 4), dtype=torch.int32), par,
                     seed, **kw)
    with pytest.raises(ValueError):             # a lane w with a 2-D x
        tkern.td_vmm(x[0], torch.zeros((2, 8, 4), dtype=torch.int32),
                     par[0], seed[:1], **kw)
