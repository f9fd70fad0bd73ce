"""Port parity: the ResNet20-family CNN (`repro_torch.models.resnet`), its
config and the keys of the noise search (`prng.split`).

Parameters come from the reference's own init (converted), images from the
reference's `make_synthetic_cifar`, at `resnet20_cifar.smoke()` (stages
8/16, one block a stage, 16x16 images, 7 sites, n_chain 144).  The JAX td
convs run the Pallas td_vmm in interpret mode.  Tolerances:

* exact: `prng.split` against `jax.random.split`, `_im2col`, the per-site
  seeds against the reference's key path, and `forward_lanes` against
  `forward` probe by probe (noise included);
* logits at sigma 0 (precise, quant, td) within rtol/atol 1e-4 and the
  argmax equal.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro.configs import resnet20_cifar as jcfg
from repro.kernels.td_vmm import ref as jref
from repro.models import common as jcommon
from repro.models import resnet as jres
from repro.tdsim.policy import TDPolicy as JPolicy
from repro_torch import convert, prng
from repro_torch.configs import resnet20_cifar as tcfg
from repro_torch.models import resnet as tres
from repro_torch.tdsim.policy import TDPolicy

CFG, JCFG = tcfg.smoke(), jcfg.smoke()
N_CHAIN = 9 * max(CFG.stages)


@pytest.mark.parametrize("words", [(0, 0), (0, 42), (123, 4567),
                                   (2 ** 32 - 1, 7)])
@pytest.mark.parametrize("n", [1, 2, 13, 29])
def test_split_equals_jax(words, n):
    want = np.asarray(jax.random.split(jnp.asarray(words, jnp.uint32), n))
    assert prng.split(words, n) == [tuple(int(v) for v in r) for r in want]


def test_split_of_typed_key_and_fold_in():
    k = jax.random.fold_in(jax.random.PRNGKey(5), 3)
    want = np.asarray(jax.random.split(k, 7))
    got = prng.split(prng.fold_in(prng.key(5), 3), 7)
    assert got == [tuple(int(v) for v in r) for r in want]


@pytest.mark.parametrize("k,stride", [(1, 1), (1, 2), (3, 1), (3, 2)])
def test_im2col_exact(k, stride):
    x = np.random.default_rng(k + stride).standard_normal(
        (2, 8, 8, 5)).astype(np.float32)
    want = np.asarray(jres._im2col(jnp.asarray(x), k, stride))
    got = tres._im2col(torch.from_numpy(x), k, stride).numpy()
    np.testing.assert_array_equal(got, want)


def test_config_and_sites_match_reference():
    assert tcfg.CONFIG == tcfg.ResNetCfg()
    assert (CFG.stages, CFG.blocks_per_stage, CFG.img, CFG.classes) == \
        (JCFG.stages, JCFG.blocks_per_stage, JCFG.img, JCFG.classes)
    for t, j in ((CFG, JCFG), (tcfg.CONFIG, jcfg.CONFIG)):
        assert tres.noise_sites(t) == jres.noise_sites(j)
        assert tres.block_strides(t) == jres.block_strides(j)
    assert len(tres.noise_sites(tcfg.CONFIG)) == 22


@pytest.fixture(scope="module")
def model():
    """The reference's quant-mode init and 6 of its synthetic images, and
    the port's copies."""
    key = jax.random.PRNGKey(0)
    jpol = JPolicy(mode="quant", bits_a=4, bits_w=4, n_chain=N_CHAIN)
    jparams = jres.init_params(key, JCFG, jpol)
    imgs, labels = jres.make_synthetic_cifar(key, 6, JCFG)
    params = convert.resnet_params_from_jax(
        jax.tree_util.tree_map(np.asarray, jparams), CFG, device="cpu")
    return dict(jparams=jparams, jimgs=imgs, params=params,
                imgs=torch.from_numpy(np.array(imgs)),
                labels=np.asarray(labels))


@pytest.mark.parametrize("mode", ["precise", "quant", "td"])
def test_forward_at_sigma0_matches_reference(model, mode):
    jpol = JPolicy(mode=mode, bits_a=4, bits_w=4, n_chain=N_CHAIN)
    pol = TDPolicy(mode=mode, bits_a=4, bits_w=4, n_chain=N_CHAIN)
    want = np.asarray(jres.forward(model["jparams"], model["jimgs"], JCFG,
                                   jpol, jax.random.PRNGKey(3)))
    got = tres.forward(model["params"], model["imgs"], CFG, pol,
                       (0, 3)).detach().numpy()
    assert got.shape == (6, CFG.classes)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


def test_per_site_policies_and_length_checked(model):
    """The port's form of test_resnet_per_site_length_checked: a list of
    one policy a site works, a wrong-length list raises."""
    n = len(tres.noise_sites(CFG))
    pol = TDPolicy(mode="quant", bits_a=4, bits_w=4, n_chain=N_CHAIN)
    mixed = [pol.replace(mode="precise") if i % 2 else pol
             for i in range(n)]
    jmixed = [JPolicy(mode=p.mode, bits_a=4, bits_w=4, n_chain=N_CHAIN)
              for p in mixed]
    got = tres.forward(model["params"], model["imgs"], CFG, mixed)
    want = np.asarray(jres.forward(model["jparams"], model["jimgs"], JCFG,
                                   jmixed))
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-4,
                               atol=1e-4)
    with pytest.raises(ValueError):
        tres.forward(model["params"], model["imgs"], CFG, [pol] * (n - 1))
    with pytest.raises(ValueError):
        tres.forward_lanes(model["params"], model["imgs"], CFG, pol,
                           torch.zeros(2, n - 1), [(0, 1), (0, 2)])


def test_site_seeds_follow_reference_key_path():
    """Probe i of layer l takes split(fold_in(key, l), per)[i]; its site
    seeds are derive_seed of fold_key at 0, 2i+1, 2i+2, 2i+2000, 999."""
    key, per = jax.random.PRNGKey(4), 13
    folds = [0, 1, 2, 3, 4, 2002, 999]          # the smoke net's sites
    for l in (0, 3):
        jkeys = jax.random.split(jax.random.fold_in(key, l), per)
        keys = prng.split(prng.fold_in((0, 4), l), per)
        got = tres.site_seeds(CFG, keys)
        for i in (0, 5, per - 1):
            want = [int(jref.derive_seed(jcommon.fold_key(jkeys[i], f)))
                    for f in folds]
            assert got[i] == want


def test_forward_lanes_equals_forward_per_probe(model):
    """Each lane (its own per-site sigma and key) against a single pass at
    that probe's per-site policies: equal bit for bit, noise included."""
    n = len(tres.noise_sites(CFG))
    pol = TDPolicy(mode="td", bits_a=4, bits_w=4, n_chain=N_CHAIN)
    sigma = torch.zeros(4, n)
    sigma[0, 1], sigma[1, 5], sigma[2, n - 1] = 2.0, 4.0, 8.0
    keys = [(0, 1), (5, 6), (7, 8), (0, 1)]
    lanes = tres.forward_lanes(model["params"], model["imgs"], CFG, pol,
                               sigma, keys)
    assert lanes.shape == (4, 6, CFG.classes)
    for p in range(4):
        pols = [pol.replace(sigma_chain=float(sigma[p, s])) for s in range(n)]
        one = tres.forward(model["params"], model["imgs"], CFG, pols,
                           keys[p]).detach()
        assert torch.equal(lanes[p], one)
    # the noise is really there
    assert not torch.equal(lanes[0], lanes[3])
    # lanes clean at every site share one pass from the stem to the head
    clean = tres.forward_lanes(model["params"], model["imgs"], CFG, pol,
                               torch.zeros(2, n), keys[:2])
    assert clean.shape == (2, 6, CFG.classes)
    for p in range(2):
        assert torch.equal(clean[p], lanes[3])


def test_forward_lanes_noisy_from_the_stem(model):
    """A chunk noisy at the stem (site 0, as the per-site search's first
    chunks are) walks every site as lanes; each lane is still its single
    pass, the projection and the head included."""
    n = len(tres.noise_sites(CFG))
    pol = TDPolicy(mode="td", bits_a=4, bits_w=4, n_chain=N_CHAIN)
    sigma = torch.zeros(3, n)
    sigma[0, 0], sigma[1, n - 2], sigma[2, n - 1] = 1.0, 3.0, 6.0
    keys = [(2, 3), (4, 5), (6, 7)]
    lanes = tres.forward_lanes(model["params"], model["imgs"], CFG, pol,
                               sigma, keys)
    for p in range(3):
        pols = [pol.replace(sigma_chain=float(sigma[p, s])) for s in range(n)]
        one = tres.forward(model["params"], model["imgs"], CFG, pols,
                           keys[p]).detach()
        assert torch.equal(lanes[p], one)


def test_resnet_params_from_jax_default_to_cuda(monkeypatch):
    """Without a device the converted parameters go to CUDA, and a host
    without it raises rather than falling back to the CPU."""
    tree = jax.tree_util.tree_map(np.asarray, jres.init_params(
        jax.random.PRNGKey(0), JCFG, JPolicy(mode="quant")))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        convert.resnet_params_from_jax(tree, CFG)


def test_init_and_synthetic_data_shapes():
    gen = torch.Generator().manual_seed(0)
    pol = TDPolicy(mode="quant", bits_a=4, bits_w=4, n_chain=N_CHAIN)
    params = tres.init_params(gen, CFG, pol, device="cpu")
    tree = convert.resnet_params_from_jax(
        jax.tree_util.tree_map(np.asarray, jres.init_params(
            jax.random.PRNGKey(0), JCFG, JPolicy(mode="quant"))), CFG,
        device="cpu")
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    mine = dict(jax.tree_util.tree_flatten_with_path(params)[0])
    assert len(flat) == len(mine)
    for path, leaf in flat:
        assert mine[path].shape == leaf.shape, path
    imgs, labels = tres.make_synthetic_cifar(gen, 5, CFG)
    assert imgs.shape == (5, CFG.img, CFG.img, 3) and imgs.dtype == \
        torch.float32
    assert labels.shape == (5,) and int(labels.max()) < CFG.classes
    again = tres.make_synthetic_cifar(torch.Generator().manual_seed(3), 5,
                                      CFG)
    same = tres.make_synthetic_cifar(torch.Generator().manual_seed(3), 5,
                                     CFG)
    assert torch.equal(again[0], same[0])
    bad = dict(tree)
    bad["blocks"] = bad["blocks"][:1]
    with pytest.raises(ValueError):
        convert.resnet_params_from_jax(
            jax.tree_util.tree_map(lambda t: t.numpy(), bad), CFG,
            device="cpu")
