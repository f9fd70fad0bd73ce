"""Port parity: the LM per-layer noise sweep of
`benchmarks/bench_noise_tolerance._lm_eval_fns` on the granite-8b smoke
model: `models.transformer.forward_lanes` (P probes as lanes), the
batched search over it, and the per-layer policy file.

* bit-exact: each lane of `forward_lanes` against `forward` at the lane's
  `NetworkPolicy` and key (with and without a clean prefix of layers,
  noise included); the batched search's layer-0 accuracies and sigma_max
  against the scalar search's; the policy file against the reference
  bench's `write_artifacts` file, and read back through both packages'
  `parse_td_per_layer`;
* against the reference's vmapped ``per_layer_eval`` at sigma 0 (td_vmm's
  Pallas kernel in interpret mode): the accuracies equal, the logits
  within 1e-5 absolute (f32 sums in another order in the batched
  matmuls).  Noisy probes are not compared with the reference: the
  Box-Muller z differs in the last ulps, which may flip a prediction.
"""
import torch_threads  # noqa: F401  (first: torch's threads under xdist)
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import repro.configs as jcfgs
from repro.launch import td_cli as jcli
from repro.models import get_api as jget_api
from repro.models import transformer as jtr
from repro.configs.base import TDExecCfg as JTD
from repro.tdsim import policy as jpolicy
import repro_torch.configs as tcfgs
from repro_torch import convert, prng
from repro_torch.configs.base import TDExecCfg as TTD
from repro_torch.core import noise_tolerance as tnt
from repro_torch.launch import td_cli as tcli
from repro_torch.models import transformer as ttr
from repro_torch.tdsim import policy as tpolicy

SIGMAS = [0.25, 0.5, 1.0, 2.0, 4.0, 8.0]
CFG = tcfgs.get_smoke("granite-8b").model
JCFG = jcfgs.get_smoke("granite-8b").model


@pytest.fixture(scope="module")
def model():
    """The reference's quant-mode init, converted; an eval batch of the
    bench's stream shape (seq 32, batch 8) from numpy."""
    jp = jget_api(JCFG)["init"](jax.random.PRNGKey(0), JCFG,
                                jpolicy.quant_policy(4, 4))
    rng = np.random.default_rng(999)
    toks = rng.integers(0, CFG.vocab, (8, 33)).astype(np.int32)
    return {"jp": jp,
            "tp": convert.params_from_jax(jax.device_get(jp), CFG,
                                          device="cpu"),
            "tokens": toks[:, :-1], "labels": toks[:, 1:]}


def _batch(model):
    return {"tokens": torch.from_numpy(model["tokens"]),
            "labels": torch.from_numpy(model["labels"])}


BASE = tpolicy.TDPolicy(mode="td", bits_a=4, bits_w=4, n_chain=CFG.d_model)
TOP = tpolicy.quant_policy(4, 4)


def _single(model, sv_row, key):
    pol = tpolicy.NetworkPolicy(layers=tuple(
        BASE.replace(sigma_chain=float(s)) for s in sv_row), top=TOP)
    with torch.no_grad():
        return ttr.forward(model["tp"], _batch(model), CFG, pol, key=key)[0]


@pytest.mark.parametrize("first_noisy", [0, 1, 2])
def test_forward_lanes_equal_single_forwards(model, first_noisy):
    sv = torch.tensor([[0.0, 0.5], [2.0, 0.0], [8.0, 4.0], [0.0, 0.0]])
    sv[:, :first_noisy] = 0.0
    keys = prng.split(prng.key(first_noisy), 4)
    lanes = ttr.forward_lanes(model["tp"], _batch(model), CFG, BASE, sv,
                              keys, TOP)
    assert lanes.shape == (4, 8, 32, CFG.vocab)
    for p in range(4):
        assert torch.equal(lanes[p], _single(model, sv[p].tolist(),
                                             keys[p])), p
    if first_noisy < CFG.n_layers:             # the noise acts
        assert not torch.equal(lanes[2], lanes[3])


def test_forward_lanes_rejects_a_wrong_sigma_shape(model):
    with pytest.raises(ValueError, match="sigma"):
        ttr.forward_lanes(model["tp"], _batch(model), CFG, BASE,
                          torch.zeros(3, CFG.n_layers), prng.split(
                              prng.key(0), 2), TOP)


def test_sigma0_probes_match_the_reference_vmapped_eval(model):
    """The bench's per_layer_eval under jax.vmap over 3 clean probes."""
    jbase = jpolicy.TDPolicy(mode="td", bits_a=4, bits_w=4,
                             n_chain=JCFG.d_model)
    jbatch = {"tokens": jnp.asarray(model["tokens"]),
              "labels": jnp.asarray(model["labels"])}

    def per_layer_eval(sigma_vec, k):
        pol = jpolicy.NetworkPolicy(layers=tuple(
            jbase.replace(sigma_chain=sigma_vec[i])
            for i in range(JCFG.n_layers)), top=jpolicy.quant_policy(4, 4))
        logits, _, _ = jtr.forward(model["jp"], jbatch, JCFG, pol, key=k)
        return (jnp.argmax(logits, -1) == jbatch["labels"]).mean(), logits

    keys = prng.split(prng.key(5), 3)
    jacc, jlogits = jax.vmap(per_layer_eval)(
        jnp.zeros((3, JCFG.n_layers), jnp.float32),
        jnp.asarray(keys, jnp.uint32))
    logits = ttr.forward_lanes(model["tp"], _batch(model), CFG, BASE,
                               torch.zeros(3, CFG.n_layers), keys, TOP)
    acc = (logits.argmax(-1) == _batch(model)["labels"]).float().mean((1, 2))
    np.testing.assert_array_equal(acc.numpy(), np.asarray(jacc))
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), rtol=0,
                               atol=1e-5)


def test_batched_search_equals_scalar_search_at_layer0(model):
    batch = _batch(model)

    def layer_eval(sv, keys):
        logits = ttr.forward_lanes(model["tp"], batch, CFG, BASE, sv, keys,
                                   TOP)
        return (logits.argmax(-1) == batch["labels"]).float().mean((1, 2))

    def scalar0(s, k):
        logits = _single(model, [s] + [0.0] * (CFG.n_layers - 1), k)
        return float((logits.argmax(-1) == batch["labels"]).float().mean())

    key = prng.key(0)
    res = tnt.find_sigma_max_batched(layer_eval, SIGMAS, key,
                                     n_layers=CFG.n_layers, n_repeats=2,
                                     chunk_size=13, device="cpu")
    res0 = tnt.find_sigma_max(scalar0, SIGMAS, prng.fold_in(key, 0),
                              n_repeats=2)
    assert res.n_evals == CFG.n_layers * 13
    np.testing.assert_array_equal(res0.rel_drop, res.rel_drop[0])
    assert res0.acc_clean == res.acc_clean[0]
    assert res0.sigma_max == res.sigma_max[0]


def test_policy_file_equals_reference_artifact(tmp_path):
    """`write_policies` writes the reference bench's per-layer policy
    file, which both CLIs' ``--td-per-layer @file`` read back."""
    from benchmarks.bench_noise_tolerance import write_artifacts
    sig = [0.75, 8.0]
    sites = ["layer0", "layer1"]
    jnet = jpolicy.solve_network_policies(sig, bits_a=4, bits_w=4,
                                          n_chain=64)
    tnet = tpolicy.solve_network_policies(sig, bits_a=4, bits_w=4,
                                          n_chain=64, device="cpu")
    write_artifacts(str(tmp_path / "ref"), {}, {}, {"lm": (sites, sig,
                                                           jnet)})
    path = tmp_path / "port" / "per_layer_policies_lm.json"
    tnt.write_policies(path, "lm", sites, sig, tnet)
    with open(tmp_path / "ref" / "per_layer_policies_lm.json") as f:
        want = json.load(f)
    with open(path) as f:
        got = json.load(f)
    for g, w in zip(got["layers"], want["layers"]):
        np.testing.assert_allclose(g.pop("sigma_chain"),
                                   w.pop("sigma_chain"), rtol=1e-6)
    assert got == want
    tl = tcli.parse_td_per_layer(f"@{path}", TTD(mode="td", n_chain=64), 2)
    jl = jcli.parse_td_per_layer(f"@{path}", JTD(mode="td", n_chain=64), 2)
    assert [(c.sigma_max, c.n_chain, c.bits_a) for c in tl] == \
        [(c.sigma_max, c.n_chain, c.bits_a) for c in jl] == \
        [(0.75, 64, 4), (8.0, 64, 4)]
