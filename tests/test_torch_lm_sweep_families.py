"""Port parity: the LM per-layer noise sweep's lanes on every decoder
family -- `models.transformer.forward_lanes` on the smoke configs of the
MoE decoders (granite-moe-1b-a400m, dbrx-132b), the mamba2 / shared
attention hybrid (zamba2-1.2b), the attention-free rwkv6-1.6b and the
stub-frontend decoder internvl2-26b (`tests/torch_sweep_parity.py`).
All bit-exact:

* each lane against the port's single `forward` at the lane's
  `NetworkPolicy` and key, noise included, with and without a clean
  prefix of layers; internvl2's batch carries patch embeddings (the
  adapter runs at the top-level policy, as in `forward`); the
  granite-moe eval batch drops 7.8% of its (token, expert) pairs at the
  default ``capacity_factor`` 1.25;
* `ffn.moe_ffn_lanes` at that capacity factor on a batch skewed to drop
  tokens: each lane routes its own tokens (its capacity is a single
  pass's) and equals `moe_ffn` on its rows; routing the folded lanes as
  one batch gives another result;
* zamba2 under a noisy td top-level policy: the shared sites draw each
  lane's noise, each lane equal to its single forward;
* the converter carries dbrx's tree over leaf by leaf;
* the smoke MoE's sweep policy file served with ``--td-per-layer @file``
  through both packages' `launch/serve`: greedy tokens equal.

The reference's vmapped eval and the searches are
`tests/test_torch_lm_sweep_reference.py`.
"""
import torch_threads  # noqa: F401  (first: torch's threads under xdist)
import numpy as np
import pytest
import torch

import jax
import repro.configs as jcfgs
from repro.launch import td_cli as jcli
from repro.models import get_api as jget_api
from repro.tdsim import policy as jpolicy
import repro_torch.configs as tcfgs
from repro_torch import convert, prng
from repro_torch.core import noise_tolerance as tnt
from repro_torch.kernels.td_vmm import ref as td_ref
from repro_torch.launch import td_cli as tcli
from repro_torch.models import ffn as tffn
from repro_torch.models import transformer as ttr
from repro_torch.tdsim import policy as tpolicy

from torch_launch_parity import archs, serve_both
from torch_sweep_parity import (acc, batch, lanes, load, model,  # noqa: F401
                                single)


@pytest.mark.parametrize("first_noisy", [0, 1])
def test_forward_lanes_equal_single_forwards(model, first_noisy):
    n_l = model["cfg"].n_layers
    sv = torch.tensor([[0.5 * (i + 1) for i in range(n_l)], [0.0] * n_l,
                       [8.0] * n_l])
    sv[:, :first_noisy] = 0.0
    keys = prng.split(prng.key(first_noisy), 3)
    out = lanes(model, sv, keys)
    assert out.shape[:2] == (3, 8)
    for p in range(3):
        assert torch.equal(out[p], single(model, sv[p].tolist(), keys[p])), p
    assert not torch.equal(out[0], out[1])          # the noise acts


def test_a_noisy_top_policy_keeps_the_shared_sites_per_lane():
    """With a noisy td top-level policy the shared block draws each
    lane's noise: the clean prefix ends before its first site, and each
    lane still equals its single forward."""
    model = load("zamba2-1.2b")
    top = tpolicy.TDPolicy(mode="td", bits_a=4, bits_w=4,
                           n_chain=model["cfg"].d_model, sigma_chain=1.5)
    sv = torch.tensor([[0.0, 0.0, 0.5], [0.0, 0.0, 0.0]])
    keys = prng.split(prng.key(4), 2)
    out = ttr.forward_lanes(model["tp"], batch(model), model["cfg"],
                            model["base"], sv, keys, top)
    for p in range(2):
        pol = tpolicy.NetworkPolicy(layers=tuple(
            model["base"].replace(sigma_chain=float(s)) for s in sv[p]),
            top=top)
        with torch.no_grad():
            want = ttr.forward(model["tp"], batch(model), model["cfg"], pol,
                               key=keys[p])[0]
        assert torch.equal(out[p], want), p


@pytest.mark.parametrize("name", ["granite-moe-1b-a400m", "dbrx-132b"])
def test_moe_lanes_route_each_lane_apart(name):
    """At the default capacity factor (1.25) this batch drops tokens; each
    lane of `moe_ffn_lanes` equals `moe_ffn` on its own rows, noise
    included, and the folded lanes routed as one batch drop other
    tokens."""
    model = load(name)
    cfg = model["cfg"]
    assert cfg.moe.capacity_factor == 1.25
    p_lanes, base = 3, model["base"]
    gen = torch.Generator().manual_seed(3)
    # a shared direction skews the routing, so some experts overflow
    x = torch.randn((p_lanes * 8, 32, cfg.d_model), generator=gen) \
        + 2.0 * torch.randn((cfg.d_model,), generator=gen)
    lp = model["tp"]["layers"][0]["moe"]
    sigma = torch.tensor([0.0, 2.0, 8.0])
    keys = prng.split(prng.key(9), p_lanes)
    seeds = torch.tensor([[[td_ref.derive_seed(k) for k in prng.split(
        prng.fold_in(key, j), cfg.moe.num_experts)] for j in range(3)]
        for key in keys], dtype=torch.int64)
    y = tffn.moe_ffn_lanes(lp, x, cfg.moe, base, sigma,
                           torch.ones(p_lanes), seeds)
    for p in range(p_lanes):
        want, aux = tffn.moe_ffn(lp, x[8 * p:8 * (p + 1)], cfg.moe,
                                 base.replace(sigma_chain=float(sigma[p])),
                                 keys[p])
        assert float(aux["moe_dropped"]) > 0, p
        assert torch.equal(y[8 * p:8 * (p + 1)], want), p
    folded, _ = tffn.moe_ffn(lp, x, cfg.moe, base.replace(sigma_chain=0.0))
    assert not torch.equal(y[:8], folded[:8])


def test_the_dbrx_tree_converts_leaf_by_leaf():
    """The converter carries dbrx's tree over, every leaf equal."""
    jcfg = jcfgs.get_smoke("dbrx-132b").model
    jp = jax.device_get(jget_api(jcfg)["init"](
        jax.random.PRNGKey(1), jcfg, jpolicy.quant_policy(4, 4)))
    tp = convert.params_from_jax(jp, tcfgs.get_smoke("dbrx-132b").model,
                                 device="cpu")
    jl = jax.tree_util.tree_leaves_with_path(jp)
    assert len(jl) == len(jax.tree_util.tree_leaves(tp))
    for path, leaf in jl:
        node = tp
        for k in path:
            node = node[k.key if hasattr(k, "key") else k.idx]
        np.testing.assert_array_equal(node.numpy(), np.asarray(leaf),
                                      err_msg=jax.tree_util.keystr(path))


def test_moe_serves_its_sweep_policy_file(tmp_path, monkeypatch):
    """The smoke MoE's per-layer sweep (the batched search over
    `forward_lanes`), its policies solved and written as the bench's
    per-layer policy file, served with ``--td-per-layer @file`` through
    both packages' `launch/serve` (each solving the file's budgets) on
    the reference's parameters: greedy tokens equal, noise on."""
    name = "granite-moe-1b-a400m"
    model = load(name)
    n_l = model["cfg"].n_layers
    res = tnt.find_sigma_max_batched(
        lambda sv, keys: acc(lanes(model, sv, keys), model),
        [0.5, 2.0, 8.0], prng.key(1), n_layers=n_l, n_repeats=1,
        chunk_size=4, device="cpu")
    solved = tpolicy.solve_network_policies(res.sigma_max, bits_a=4,
                                            bits_w=4, n_chain=48,
                                            device="cpu")
    path = tmp_path / "per_layer_policies_granite-moe.json"
    tnt.write_policies(path, name, [f"layer{i}" for i in range(n_l)],
                       res.sigma_max, solved)
    ja, ta = archs(name, mode="td")
    pair = (jcli.apply_td_args(ja, None, f"@{path}"),
            tcli.apply_td_args(ta, None, f"@{path}"))
    assert [c.sigma_max for c in pair[1].td_per_layer] == \
        [c.sigma_max for c in pair[0].td_per_layer] == \
        [float(s) for s in res.sigma_max]
    got, want, _ = serve_both(name, 2, 8, 6, monkeypatch, pair=pair)
    np.testing.assert_array_equal(got, want)
