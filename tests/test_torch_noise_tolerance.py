"""Port parity: the Fig. 10 noise loop (`repro_torch.core.noise_tolerance`)
and the Monte-Carlo check of the chain statistics
(`repro_torch.core.chain.simulate_chain_errors`).

* On deterministic evals (the reference's ramp and per-layer weighted
  evals of tests/test_noise_tolerance_props.py) `crossing_sigma`,
  `find_sigma_max` and `find_sigma_max_batched` equal the reference's
  results: rel_drop and sigma_max to 1e-12.  Chunked equals unchunked
  exactly, and the evals see the reference's key schedule.
* On the smoke ResNet (td mode, 8 images) the batched sweep equals the
  port's own per-probe scalar calls exactly, and its sigma-0 probes'
  accuracies equal the reference's vmapped sweep (Pallas td_vmm in
  interpret mode; a 2-point grid, one repeat).  Its noisy probes are not
  compared with the reference: Box-Muller z differs in the last ulps
  between torch and XLA, which may flip a prediction.
* `simulate_chain_errors` (n 64, bits 4, R 2, 20000 draws): mean within
  5 sigma / sqrt(n_mc) and std within 5% of `chain_stats`, the
  reference test's bounds (tests/test_core_cells.py).
"""
import torch_threads  # noqa: F401  (first: torch's threads under xdist)
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro.configs import resnet20_cifar as jcfg
from repro.core import noise_tolerance as jnt
from repro.models import resnet as jres
from repro.tdsim.policy import TDPolicy as JPolicy
from repro_torch import convert, prng
from repro_torch.configs import resnet20_cifar as tcfg
from repro_torch.core import chain
from repro_torch.core import noise_tolerance as tnt
from repro_torch.models import resnet as tres
from repro_torch.tdsim.policy import TDPolicy

SIGMAS = [0.25, 0.5, 1.0, 2.0, 4.0, 8.0]
CPU = "cpu"


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a, np.float64),
                               np.asarray(b, np.float64), rtol=0,
                               atol=1e-12)


def _ramp(slope):
    def eval_fn(sigma, key):
        return 1.0 - slope * float(sigma)
    return eval_fn


def _jlayered(weights):
    w = jnp.asarray(weights, jnp.float32)
    return lambda sigma_vec, key: 1.0 - jnp.sum(w * sigma_vec)


def _tlayered(weights):
    w = torch.tensor(weights, dtype=torch.float32)
    return lambda sigma_vecs, keys: 1.0 - (w * sigma_vecs).sum(-1)


def test_crossing_sigma_matches_reference():
    rng = np.random.default_rng(0)
    sig = np.asarray(SIGMAS)
    drops = rng.uniform(0.0, 0.05, size=(64, len(sig)))
    drops[0] = 0.0                                   # no crossing
    drops[1, 0] = 0.5                                # crossing at index 0
    for thr in (0.01, 0.02):
        _close(tnt.crossing_sigma(sig, drops, thr),
               jnt.crossing_sigma(sig, drops, thr))
    _close(tnt.crossing_sigma([2.0], [[0.5], [0.0]]),
           jnt.crossing_sigma([2.0], [[0.5], [0.0]]))
    np.testing.assert_array_equal(tnt.probe_vectors(SIGMAS, 3, 2),
                                  jnt.probe_vectors(SIGMAS, 3, 2))


@pytest.mark.parametrize("slope", [0.0, 1e-3, 4e-3, 0.02, 0.5])
@pytest.mark.parametrize("n_repeats", [1, 3])
def test_find_sigma_max_matches_reference(slope, n_repeats):
    want = jnt.find_sigma_max(_ramp(slope), SIGMAS, jax.random.PRNGKey(0),
                              n_repeats=n_repeats)
    got = tnt.find_sigma_max(_ramp(slope), SIGMAS, prng.key(0),
                             n_repeats=n_repeats)
    _close(got.rel_drop, want.rel_drop)
    _close(got.sigma_max, want.sigma_max)
    assert got.acc_clean == want.acc_clean


@pytest.mark.parametrize("weights", [[0.004], [1e-3, 0.5, 0.02],
                                     [0.0, 0.9, 0.003, 0.011, 2e-3]])
def test_find_sigma_max_batched_matches_reference(weights):
    key = jax.random.PRNGKey(7)
    want = jnt.find_sigma_max_batched(_jlayered(weights), SIGMAS, key,
                                      n_layers=len(weights), n_repeats=2)
    got = tnt.find_sigma_max_batched(_tlayered(weights), SIGMAS, (0, 7),
                                     n_layers=len(weights), n_repeats=2,
                                     device=CPU)
    _close(got.rel_drop, want.rel_drop)
    _close(got.sigma_max, want.sigma_max)
    _close(got.acc_clean, want.acc_clean)
    assert got.n_evals == want.n_evals
    one = got.layer(len(weights) - 1)
    assert one.sigma_max == float(got.sigma_max[-1])


@pytest.mark.parametrize("chunk", [1, 4, 13, 40])
def test_chunked_matches_unchunked(chunk):
    weights = [1e-3, 0.5, 0.02]
    calls = []

    def eval_fn(v, k):
        calls.append(v.shape[0])
        return _tlayered(weights)(v, k)
    full = tnt.find_sigma_max_batched(eval_fn, SIGMAS, (0, 5), n_layers=3,
                                      n_repeats=2, device=CPU)
    n_full = len(calls)
    chunked = tnt.find_sigma_max_batched(eval_fn, SIGMAS, (0, 5),
                                         n_layers=3, n_repeats=2,
                                         chunk_size=chunk, device=CPU)
    np.testing.assert_array_equal(full.sigma_max, chunked.sigma_max)
    np.testing.assert_array_equal(full.rel_drop, chunked.rel_drop)
    np.testing.assert_array_equal(full.acc_clean, chunked.acc_clean)
    # every call has the chunk's P (the tail padded)
    assert n_full == 1 and set(calls[1:]) == {min(chunk, 39)}
    with pytest.raises(ValueError):
        tnt.find_sigma_max_batched(eval_fn, SIGMAS, (0, 5), n_layers=3,
                                   chunk_size=0, device=CPU)


def test_batched_keys_follow_reference_schedule():
    """Layer l's probes see split(fold_in(key, l), S*R + 1), in order."""
    seen = []

    def eval_fn(v, keys):
        seen.extend(keys)
        return torch.ones(v.shape[0])
    tnt.find_sigma_max_batched(eval_fn, SIGMAS[:2], (0, 11), n_layers=3,
                               n_repeats=2, chunk_size=4, device=CPU)
    key = jax.random.PRNGKey(11)
    want = [tuple(int(v) for v in k) for li in range(3) for k in
            np.asarray(jax.random.split(jax.random.fold_in(key, li), 5))]
    assert seen[:15] == want
    with pytest.raises(NotImplementedError, match="item 9"):
        tnt.find_sigma_max_batched(eval_fn, SIGMAS, (0, 11), n_layers=3,
                                   mesh=object(), device=CPU)


# ---------------------------------------------------------------------------
# the smoke ResNet
# ---------------------------------------------------------------------------
CFG, JCFG = tcfg.smoke(), jcfg.smoke()
GRID = [1.0, 8.0]
N_CHAIN = 9 * max(CFG.stages)


@pytest.fixture(scope="module")
def resnet():
    key = jax.random.PRNGKey(0)
    jparams = jres.init_params(key, JCFG, JPolicy(mode="quant"))
    imgs, labels = jres.make_synthetic_cifar(jax.random.fold_in(key, 999),
                                             8, JCFG)
    params = convert.resnet_params_from_jax(
        jax.tree_util.tree_map(np.asarray, jparams), CFG, device="cpu")
    n = len(tres.noise_sites(CFG))
    base = TDPolicy(mode="td", bits_a=4, bits_w=4, n_chain=N_CHAIN)
    timgs = torch.from_numpy(np.array(imgs))
    tlabels = torch.from_numpy(np.array(labels)).long()

    def lanes_eval(sv, keys):
        logits = tres.forward_lanes(params, timgs, CFG, base, sv, keys)
        return (logits.argmax(-1) == tlabels).float().mean(-1)

    def scalar_eval(layer):
        def eval_fn(s, k):
            pols = [base.replace(sigma_chain=s if i == layer else 0.0)
                    for i in range(n)]
            with torch.no_grad():
                logits = tres.forward(params, timgs, CFG, pols, k)
            return float((logits.argmax(-1) == tlabels).float().mean())
        return eval_fn

    jbase = JPolicy(mode="td", bits_a=4, bits_w=4, n_chain=N_CHAIN,
                    sigma_chain=0.0, tdc_q=1)

    def jeval(sigma_vec, k):
        pols = [jbase.replace(sigma_chain=sigma_vec[i]) for i in range(n)]
        logits = jres.forward(jparams, imgs, JCFG, pols, k)
        return (jnp.argmax(logits, -1) == labels).mean()

    return dict(n=n, lanes_eval=lanes_eval, scalar_eval=scalar_eval,
                jeval=jeval)


def test_resnet_batched_sweep_equals_per_probe_scalar_calls(resnet):
    n = resnet["n"]
    bres = tnt.find_sigma_max_batched(resnet["lanes_eval"], GRID, (0, 0),
                                      n_layers=n, n_repeats=1,
                                      chunk_size=4, device=CPU)
    assert bres.rel_drop.shape == (n, len(GRID))
    for l in range(n):
        sres = tnt.find_sigma_max(resnet["scalar_eval"](l), GRID,
                                  prng.fold_in((0, 0), l), n_repeats=1)
        np.testing.assert_array_equal(bres.rel_drop[l], sres.rel_drop)
        assert bres.acc_clean[l] == sres.acc_clean
        assert bres.sigma_max[l] == sres.sigma_max
    # the noise really reaches the accuracy somewhere in the sweep
    assert np.abs(bres.rel_drop).max() > 0


def test_resnet_sigma0_probes_equal_reference(resnet):
    n = resnet["n"]
    want = jnt.find_sigma_max_batched(resnet["jeval"], GRID,
                                      jax.random.PRNGKey(0), n_layers=n,
                                      n_repeats=1)
    got = tnt.find_sigma_max_batched(resnet["lanes_eval"], GRID, (0, 0),
                                     n_layers=n, n_repeats=1, device=CPU)
    np.testing.assert_array_equal(got.acc_clean, want.acc_clean)
    assert got.acc_clean.min() > 0


def test_simulate_chain_errors_matches_law_of_total_variance():
    bits, r, n, n_mc = 4, 2.0, 64, 20000
    mu_a, sig_a = chain.chain_stats(float(n), chain.cell_stats(bits, r))
    errs = chain.simulate_chain_errors(torch.Generator().manual_seed(0), n,
                                       bits, r, n_mc=n_mc, device=CPU)
    assert errs.shape == (n_mc,)
    assert abs(float(errs.mean()) - float(mu_a)) < \
        5 * float(sig_a) / np.sqrt(n_mc)
    assert abs(float(errs.std()) - float(sig_a)) / float(sig_a) < 0.05


def test_chain_stats_matches_reference():
    from repro.core import chain as jchain
    st = chain.cell_stats(4, 2.0)
    jst = jchain.cell_stats(4, 2.0)
    for n in (64.0, 576.0):
        mu, sig = chain.chain_stats(n, st)
        jmu, jsig = jchain.chain_stats(jnp.asarray(n), jst)
        np.testing.assert_allclose(float(mu), float(jmu), rtol=1e-6)
        np.testing.assert_allclose(float(sig), float(jsig), rtol=1e-6)
