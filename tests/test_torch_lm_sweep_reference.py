"""Port parity: the LM per-layer noise sweep on every decoder family
against the reference (`tests/torch_sweep_parity.py`'s smoke models:
granite-moe-1b-a400m, dbrx-132b, zamba2-1.2b, rwkv6-1.6b,
internvl2-26b).

* sigma-0 probes of `models.transformer.forward_lanes` against the
  reference's ``jax.vmap`` of `transformer.forward` (the bench's
  ``per_layer_eval``; td_vmm's Pallas kernel in interpret mode):
  accuracies equal, logits within 1e-5 absolute (f32 sums in another
  order).  Noisy probes are not compared with the reference: the
  Box-Muller z differs in the last ulps, which may flip a prediction;
* the batched search over the lanes (the bench's recipe: six sigmas, 2
  repeats, chunk 13) against the scalar search at layer 0: the
  accuracies, rel_drop and sigma_max equal.
"""
import torch_threads  # noqa: F401  (first: torch's threads under xdist)
import numpy as np
import torch

import jax
import jax.numpy as jnp
from repro.models import transformer as jtr
from repro.tdsim import policy as jpolicy
from repro_torch import prng
from repro_torch.core import noise_tolerance as tnt

from torch_sweep_parity import acc, batch, lanes, model, single  # noqa: F401

SIGMAS = [0.25, 0.5, 1.0, 2.0, 4.0, 8.0]


def test_sigma0_probes_match_the_reference_vmapped_eval(model):
    """The bench's per_layer_eval under jax.vmap over 3 clean probes."""
    jcfg = model["jcfg"]
    jbase = jpolicy.TDPolicy(mode="td", bits_a=4, bits_w=4,
                             n_chain=jcfg.d_model)
    jbatch = {k: jnp.asarray(v) for k, v in batch(model).items()}

    def per_layer_eval(sigma_vec, k):
        pol = jpolicy.NetworkPolicy(layers=tuple(
            jbase.replace(sigma_chain=sigma_vec[i])
            for i in range(jcfg.n_layers)), top=jpolicy.quant_policy(4, 4))
        logits, _, _ = jtr.forward(model["jp"], jbatch, jcfg, pol, key=k)
        return logits

    keys = prng.split(prng.key(5), 3)
    jlogits = np.array(jax.vmap(per_layer_eval)(
        jnp.zeros((3, jcfg.n_layers), jnp.float32),
        jnp.asarray(keys, jnp.uint32)))
    logits = lanes(model, torch.zeros(3, jcfg.n_layers), keys)
    np.testing.assert_array_equal(
        acc(logits, model).numpy(),
        acc(torch.from_numpy(jlogits), model).numpy())
    np.testing.assert_allclose(logits.numpy(), jlogits, rtol=0, atol=1e-5)


def test_batched_search_equals_scalar_search_at_layer0(model):
    n_l = model["cfg"].n_layers

    def layer_eval(sv, keys):
        return acc(lanes(model, sv, keys), model)

    def scalar0(s, k):
        return float(acc(single(model, [s] + [0.0] * (n_l - 1), k), model))

    key = prng.key(0)
    res = tnt.find_sigma_max_batched(layer_eval, SIGMAS, key, n_layers=n_l,
                                     n_repeats=2, chunk_size=13,
                                     device="cpu")
    res0 = tnt.find_sigma_max(scalar0, SIGMAS, prng.fold_in(key, 0),
                              n_repeats=2)
    assert res.n_evals == n_l * 13
    np.testing.assert_array_equal(res0.rel_drop, res.rel_drop[0])
    assert res0.acc_clean == res.acc_clean[0]
    assert res0.sigma_max == res.sigma_max[0]
