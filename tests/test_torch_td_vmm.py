"""Port parity: the TD-VMM engine of `repro_torch` against `repro`.

The JAX side runs as the reference's own tests run it on the CPU: the
production `td_vmm_pallas`, which interprets the Pallas kernel off a TPU.
The port's side is the kernel wrapper, which on CPU tensors runs the
kernel's plain PyTorch version.  Tolerances:

* bit-exact: `hash32`, `_uniform`, `derive_seed`, and every output at
  sigma = 0 for tdc_q in {1, 2, 3} (integer-valued results);
* Box-Muller z within 1e-4 (log/cos differ by ulps between torch and XLA);
* noisy outputs: equal except on at most 1% of entries, and every
  difference a multiple of tdc_q (a z near a rounding boundary flips one
  plane's TDC step, q * 2^b).
"""
import torch_threads  # noqa: F401  (first: torch's threads under xdist)
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro.kernels.td_vmm import ref as jref
from repro.kernels.td_vmm.td_vmm import td_vmm_pallas
from repro.tdsim import td_linear as jlin
from repro.tdsim.policy import TDPolicy as JPolicy
from repro_torch.kernels.td_vmm import ops as tops
from repro_torch.kernels.td_vmm import ref as tref
from repro_torch.kernels.td_vmm import td_vmm as tkern
from repro_torch.tdsim import td_linear as tlin
from repro_torch.tdsim.policy import TDPolicy

SEED = tref.derive_seed((0, 0))


def _u32(n, seed=0):
    a = np.random.default_rng(seed).integers(0, 2 ** 32, size=n,
                                             dtype=np.uint64)
    a[:4] = [0, 1, 2 ** 31, 2 ** 32 - 1]
    return a.astype(np.uint32)


def test_hash32_and_uniform_bit_exact():
    x = _u32(1 << 14)
    xt = torch.from_numpy(x.astype(np.int64))
    want = np.asarray(jref.hash32(jnp.asarray(x)))
    got = tref.hash32(xt)
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    np.testing.assert_array_equal(
        tref._uniform(got).numpy(),
        np.asarray(jref._uniform(jnp.asarray(want))))


@pytest.mark.parametrize("words", [(0, 0), (0, 42), (7, 0),
                                   (0xDEADBEEF, 0x12345678),
                                   (2 ** 32 - 1, 2 ** 32 - 1)])
def test_derive_seed_bit_exact(words):
    want = int(jref.derive_seed(jnp.asarray(words, jnp.uint32)))
    assert tref.derive_seed(words) == want


def test_derive_seed_of_prng_keys():
    for key in (jax.random.PRNGKey(0), jax.random.PRNGKey(123),
                jax.random.fold_in(jax.random.PRNGKey(5), 3)):
        words = np.asarray(key).tolist()
        assert tref.derive_seed(words) == int(jref.derive_seed(key))
    # the serve steps' keyless matmuls: PRNGKey(0) -> derive_seed((0, 0))
    assert tref.derive_seed((0, 0)) == int(
        jref.derive_seed(jax.random.PRNGKey(0)))


def test_gauss_noise_uniform_streams_exact_z_close():
    idx = _u32(1 << 16, seed=3)
    seed = 0x5EED1234
    z_j = np.asarray(jref.gauss_noise(jnp.asarray(idx), jnp.uint32(seed)))
    z_t = tref.gauss_noise(torch.from_numpy(idx.astype(np.int64)), seed)
    np.testing.assert_allclose(z_t.numpy(), z_j, rtol=0, atol=1e-4)
    assert abs(float(z_t.mean())) < 0.02 and abs(float(z_t.std()) - 1) < 0.02


def _codes(rng, shape, bits):
    lo = -(2 ** (bits - 1))
    return rng.integers(lo, -lo, size=shape).astype(np.int32)


def _pallas(x, w, sigma, q, n_chain, bits_a, bits_w, seed=SEED):
    k = x.shape[1]
    n_seg = max(1, -(-k // n_chain))
    kp = n_seg * n_chain
    xp = np.pad(x, ((0, 0), (0, kp - k)))
    wp = np.pad(w, ((0, kp - k), (0, 0)))
    return np.asarray(td_vmm_pallas(
        jnp.asarray(xp), jnp.asarray(wp), jnp.asarray([sigma, q], jnp.float32),
        jnp.uint32(seed), bits_a=bits_a, bits_w=bits_w, n_chain=n_chain,
        k_true=k))


def _port(x, w, sigma, q, n_chain, bits_a, bits_w, seed=SEED):
    return tkern.td_vmm(
        torch.from_numpy(x), torch.from_numpy(w),
        torch.tensor([sigma, q], dtype=torch.float32),
        torch.tensor([seed], dtype=torch.int64), bits_a=bits_a,
        bits_w=bits_w, n_chain=n_chain).numpy()


SHAPES = [  # (M, K, N, n_chain): K tails, ragged M and N, several segments
    (5, 100, 7, 16),
    (3, 70, 9, 48),
    (9, 161, 13, 48),
    (1, 40, 33, 16),
]


@pytest.mark.parametrize("tdc_q", [1, 2, 3])
@pytest.mark.parametrize("m,k,n,n_chain", SHAPES)
def test_sigma0_bit_exact_against_pallas(m, k, n, n_chain, tdc_q):
    rng = np.random.default_rng(m * k + n)
    x, w = _codes(rng, (m, k), 4), _codes(rng, (k, n), 4)
    launches = tkern.launches
    got = _port(x, w, 0.0, tdc_q, n_chain, 4, 4)
    assert tkern.launches == launches      # CPU tensors: plain version
    np.testing.assert_array_equal(got, _pallas(x, w, 0.0, tdc_q, n_chain,
                                               4, 4))
    want_ref = tref.td_vmm_signed_ref(
        torch.from_numpy(x), torch.from_numpy(w), bits_a=4, bits_w=4,
        n_chain=n_chain, sigma=0.0, tdc_q=tdc_q, seed=SEED)
    np.testing.assert_array_equal(got, want_ref.numpy())
    if tdc_q == 1:
        np.testing.assert_array_equal(got, (x @ w).astype(np.float32))


@pytest.mark.parametrize("bits_a,bits_w", [(2, 3), (8, 8), (6, 4)])
def test_sigma0_bit_exact_other_widths(bits_a, bits_w):
    rng = np.random.default_rng(bits_a * 10 + bits_w)
    x, w = _codes(rng, (4, 90), bits_a), _codes(rng, (90, 6), bits_w)
    np.testing.assert_array_equal(
        _port(x, w, 0.0, 2, 32, bits_a, bits_w),
        _pallas(x, w, 0.0, 2, 32, bits_a, bits_w))


@pytest.mark.parametrize("sigma,tdc_q", [(0.7, 1), (1.9179178476333618, 2),
                                         (0.55, 6)])
def test_noisy_outputs_agree_up_to_rare_tdc_flips(sigma, tdc_q):
    rng = np.random.default_rng(int(sigma * 100))
    x, w = _codes(rng, (16, 200), 4), _codes(rng, (200, 24), 4)
    got = _port(x, w, sigma, tdc_q, 48, 4, 4)
    want = _pallas(x, w, sigma, tdc_q, 48, 4, 4)
    diff = got - want
    assert (diff != 0).mean() <= 0.01
    np.testing.assert_array_equal(np.mod(diff, tdc_q), 0)
    # the noise is really there
    assert (got != (x @ w)).mean() > 0.05
    np.testing.assert_array_equal(
        got, tref.td_vmm_signed_ref(
            torch.from_numpy(x), torch.from_numpy(w), bits_a=4, bits_w=4,
            n_chain=48, sigma=sigma, tdc_q=tdc_q, seed=SEED).numpy())


def test_ops_flatten_lead_dims_and_key():
    rng = np.random.default_rng(9)
    x, w = _codes(rng, (2, 3, 50), 4), _codes(rng, (50, 5), 4)
    pol = TDPolicy(mode="td", n_chain=16, sigma_chain=0.9, tdc_q=2)
    jpol = JPolicy(mode="td", n_chain=16, sigma_chain=0.9, tdc_q=2)
    from repro.kernels.td_vmm import ops as jops
    want = np.asarray(jops.td_vmm(jnp.asarray(x), jnp.asarray(w), jpol,
                                  jnp.asarray([0, 7], jnp.uint32)))
    got = tops.td_vmm(torch.from_numpy(x), torch.from_numpy(w), pol,
                      (0, 7)).numpy()
    assert got.shape == (2, 3, 5)
    assert (got != want).mean() <= 0.01


def test_wrapper_rejects_bad_operands():
    x = torch.zeros((2, 8), dtype=torch.int32)
    w = torch.zeros((8, 3), dtype=torch.int32)
    par = torch.tensor([0.0, 1.0])
    seed = torch.tensor([1])
    kw = dict(bits_a=4, bits_w=4, n_chain=8)
    with pytest.raises(TypeError):
        tkern.td_vmm(x.float(), w, par, seed, **kw)
    with pytest.raises(ValueError):
        tkern.td_vmm(x, w[:4], par, seed, **kw)
    with pytest.raises(TypeError):
        tkern.td_vmm(x, w, par.double(), seed, **kw)
    with pytest.raises(ValueError):
        tkern.td_vmm(x, w, par, seed, bits_a=9, bits_w=4, n_chain=8)


def _fp(rng, shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


@pytest.mark.parametrize("mode", ["quant", "td"])
@pytest.mark.parametrize("n_chain", [16, 48])
def test_td_matmul_matches_reference(mode, n_chain):
    rng = np.random.default_rng(n_chain)
    x, w = _fp(rng, (2, 5, 100)), _fp(rng, (100, 12), 0.1)
    s_a, s_w = np.float32(0.7559289), np.float32(0.035)
    jpol = JPolicy(mode=mode, n_chain=n_chain)
    tpol = TDPolicy(mode=mode, n_chain=n_chain)
    want = np.asarray(jlin.td_matmul(jnp.asarray(x), jnp.asarray(w),
                                     jnp.asarray(s_a), jnp.asarray(s_w),
                                     jpol))
    got = tlin.td_matmul(torch.from_numpy(x), torch.from_numpy(w),
                         torch.tensor(s_a), torch.tensor(s_w), tpol).numpy()
    # quant: one f32 matmul of fake-quant values (summation order may
    # differ); td at sigma = 0: integer product times s_a * s_w
    if mode == "td":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_td_matmul_noisy_keyless_seed_matches_reference():
    rng = np.random.default_rng(5)
    x, w = _fp(rng, (6, 130)), _fp(rng, (130, 10), 0.1)
    s_a, s_w = np.float32(0.7559289), np.float32(0.03)
    jpol = JPolicy(mode="td", n_chain=48, sigma_chain=1.2, tdc_q=2)
    tpol = TDPolicy(mode="td", n_chain=48, sigma_chain=1.2, tdc_q=2)
    want = np.asarray(jlin.td_matmul(jnp.asarray(x), jnp.asarray(w),
                                     jnp.asarray(s_a), jnp.asarray(s_w), jpol))
    got = tlin.td_matmul(torch.from_numpy(x), torch.from_numpy(w),
                         torch.tensor(s_a), torch.tensor(s_w), tpol).numpy()
    step = float(np.float32(s_a) * np.float32(s_w))
    assert (got != want).mean() <= 0.01
    np.testing.assert_allclose(np.round((got - want) / step / 2),
                               (got - want) / step / 2, atol=1e-3)


def test_td_matmul_int_oracle_equals_kernel_at_sigma0():
    rng = np.random.default_rng(11)
    x, w = _codes(rng, (3, 4, 77), 4), _codes(rng, (77, 9), 4)
    pol = TDPolicy(mode="td", n_chain=16, tdc_q=3)
    want = np.asarray(jlin.td_matmul_int(
        jnp.asarray(x), jnp.asarray(w),
        JPolicy(mode="td", n_chain=16, tdc_q=3), jax.random.PRNGKey(0)))
    got = tlin.td_matmul_int(torch.from_numpy(x), torch.from_numpy(w), pol)
    np.testing.assert_array_equal(got.numpy(), want)


def test_init_linear_distributions():
    gen = torch.Generator().manual_seed(0)
    p = tlin.init_linear(gen, 512, 256, TDPolicy(mode="td"))
    assert p["w"].shape == (512, 256) and p["w"].dtype == torch.float32
    assert abs(float(p["w"].std()) * 512 ** 0.5 - 1.0) < 0.02
    np.testing.assert_allclose(
        float(p["s_w"]), 2 * float(p["w"].abs().mean()) / 7 ** 0.5,
        rtol=1e-6)
    assert float(p["s_a"]) == float(np.float32(2 / 7 ** 0.5))
    pb = tlin.init_linear(torch.Generator().manual_seed(0), 64, 8,
                          TDPolicy(mode="quant"), dtype=torch.bfloat16)
    assert pb["w"].dtype == pb["s_w"].dtype == torch.bfloat16
    assert "s_w" not in tlin.init_linear(gen, 4, 4, TDPolicy())
