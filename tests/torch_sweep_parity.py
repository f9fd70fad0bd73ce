"""Shared harness of the LM sweep's family tests
(`tests/test_torch_lm_sweep_families.py`,
`tests/test_torch_lm_sweep_reference.py`): the smoke models of every
decoder family from the reference's converted quant-mode init, an eval
batch of the bench's stream shape (8 x 32) from numpy (with patch
embeddings for a stub frontend), and the port's single and lane
forwards.  Not a test module."""
import functools

import numpy as np
import pytest
import torch

import jax
import repro.configs as jcfgs
from repro.models import get_api as jget_api
from repro.tdsim import policy as jpolicy
import repro_torch.configs as tcfgs
from repro_torch import convert
from repro_torch.models import transformer as ttr
from repro_torch.tdsim import policy as tpolicy

NAMES = ["granite-moe-1b-a400m", "dbrx-132b", "zamba2-1.2b", "rwkv6-1.6b",
         "internvl2-26b"]
TOP = tpolicy.quant_policy(4, 4)
N_PATCHES = 4


@functools.lru_cache(maxsize=None)
def load(name: str) -> dict:
    """One smoke model: the reference's quant-mode init, converted, and an
    eval batch (tokens, labels, and patch embeddings for a frontend) from
    numpy."""
    jcfg = jcfgs.get_smoke(name).model
    cfg = tcfgs.get_smoke(name).model
    jp = jget_api(jcfg)["init"](jax.random.PRNGKey(0), jcfg,
                                jpolicy.quant_policy(4, 4))
    rng = np.random.default_rng(999)
    toks = rng.integers(0, cfg.vocab, (8, 33)).astype(np.int32)
    m = {"name": name, "cfg": cfg, "jcfg": jcfg, "jp": jp,
         "tp": convert.params_from_jax(jax.device_get(jp), cfg,
                                       device="cpu"),
         "tokens": toks[:, :-1], "labels": toks[:, 1:],
         "base": tpolicy.TDPolicy(mode="td", bits_a=4, bits_w=4,
                                  n_chain=cfg.d_model)}
    if cfg.frontend is not None:
        m["embeds"] = rng.standard_normal(
            (8, N_PATCHES, cfg.d_frontend), dtype=np.float32)
    return m


@pytest.fixture(scope="module", params=NAMES)
def model(request):
    return load(request.param)


def batch(model) -> dict:
    b = {"tokens": torch.from_numpy(model["tokens"])}
    if "embeds" in model:
        b["embeds"] = torch.from_numpy(model["embeds"])
    return b


def acc(logits, model) -> torch.Tensor:
    """Next-token top-1 over the token positions (after any patches)."""
    labels = torch.from_numpy(model["labels"])
    pred = logits[..., -labels.shape[-1]:, :].argmax(-1)
    return (pred == labels).float().mean((-2, -1))


def single(model, sv_row, key) -> torch.Tensor:
    """The port's `forward` at a probe's per-layer sigmas and key."""
    pol = tpolicy.NetworkPolicy(layers=tuple(
        model["base"].replace(sigma_chain=float(s)) for s in sv_row),
        top=TOP)
    with torch.no_grad():
        return ttr.forward(model["tp"], batch(model), model["cfg"], pol,
                           key=key)[0]


def lanes(model, sv, keys) -> torch.Tensor:
    return ttr.forward_lanes(model["tp"], batch(model), model["cfg"],
                             model["base"], sv, keys, TOP)
