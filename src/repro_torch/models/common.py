"""Shared model building blocks (port of `repro/models/common.py`): policy
resolution, the dense layer, RMSNorm, RoPE, embeddings, the cross-entropy
loss, PRNG key folding and dtype casts.

Parameters are plain nested dicts of tensors, laid out as in the reference
(a dense weight is (K, N) and ``dense`` computes ``x @ w``), so that
`repro_torch.convert.params_from_jax` is a leaf-by-leaf copy.
"""
from __future__ import annotations

import torch

from repro_torch import prng
from repro_torch.configs.base import ArchConfig, TDExecCfg
from repro_torch.tdsim import policy as td_policy
from repro_torch.tdsim import td_linear

pol_at = td_policy.pol_at
pol_top = td_policy.pol_top
pol_attn = td_policy.pol_attn


# ---------------------------------------------------------------------------
# TD policy resolution
# ---------------------------------------------------------------------------
def resolve_policy(td: TDExecCfg) -> td_policy.TDPolicy:
    """One layer config -> its policy.  "td" reads the reference's solved
    (R, q, sigma_chain) from `tdsim.policy.SOLVED` until the core/ solve is
    ported (ROADMAP §1, step 6)."""
    if td.mode == "precise":
        return td_policy.PRECISE
    if td.mode == "quant":
        return td_policy.quant_policy(td.bits_a, td.bits_w)
    if td.mode == "td":
        return td_policy.solved_td_policy(td.bits_a, td.bits_w, td.n_chain,
                                          td.sigma_max)
    raise ValueError(f"unknown td mode {td.mode!r}")


def resolve_arch_policy(arch: ArchConfig) -> td_policy.TDPolicy:
    """An ArchConfig's homogeneous execution policy.  Per-layer policies,
    TD attention and scenario/corner resolution are not ported yet."""
    if arch.td_per_layer is not None:
        raise NotImplementedError("per-layer TD policies (td_per_layer) are "
                                  "not yet ported (ROADMAP.md §1, step 7)")
    td_attn = getattr(arch, "td_attn", None)
    if td_attn is not None and td_attn.mode != "precise":
        raise NotImplementedError("TD attention (td_attn) is not yet ported "
                                  "(ROADMAP.md §1, step 9)")
    if arch.scenario is not None or arch.corner is not None:
        raise NotImplementedError("scenario/corner resolution is not yet "
                                  "ported (ROADMAP.md §1, step 7)")
    return resolve_policy(arch.td)


# ---------------------------------------------------------------------------
# Initializers / dense layer
# ---------------------------------------------------------------------------
def dense_init(gen: torch.Generator, d_in: int, d_out: int, pol,
               bias: bool = False, dtype=torch.float32,
               scale: float | None = None, device=None) -> dict:
    return td_linear.init_linear(gen, d_in, d_out, pol, bias, dtype, scale,
                                 device)


def dense(params: dict, x: torch.Tensor, pol, key=None) -> torch.Tensor:
    return td_linear.linear(params, x, pol, key)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------
def rmsnorm_init(d: int, dtype=torch.float32, device=None) -> dict:
    return {"scale": torch.ones((d,), dtype=dtype, device=device)}


def rmsnorm(params: dict, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * params["scale"].to(torch.float32)).to(dt)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------
def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., S, H, Dh); positions: broadcastable to (..., S)."""
    hd = x.shape[-1]
    inv = rope_freqs(hd, theta, x.device)
    ang = positions[..., None].to(torch.float32) * inv
    cos = torch.cos(ang)[..., None, :]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Embedding / dtype
# ---------------------------------------------------------------------------
def embed_init(gen: torch.Generator, vocab: int, d: int, dtype=torch.float32,
               device=None) -> dict:
    t = torch.randn((vocab, d), generator=gen, dtype=torch.float32,
                    device=device) * 0.02
    return {"table": t.to(dtype)}


def embed(params: dict, ids: torch.Tensor) -> torch.Tensor:
    return params["table"][ids]


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: torch.Tensor | None = None,
                  z_coef: float = 1e-4) -> torch.Tensor:
    """Mean next-token CE with z-loss; logits (..., V), labels (...)."""
    logits = logits.to(torch.float32)
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels[..., None].to(torch.int64))[..., 0]
    loss = (lse - ll) + z_coef * lse ** 2
    if mask is not None:
        loss = loss * mask
        return loss.sum() / torch.clamp(mask.sum(), min=1.0)
    return loss.mean()


def fold_key(key, *idx: int):
    """``jax.random.fold_in`` over ``idx`` in turn; a key is a host pair of
    uint32 words (`repro_torch.prng`), None stays None."""
    if key is None:
        return None
    for i in idx:
        key = prng.fold_in(key, i)
    return key


def cast_tree(tree, dtype):
    """Cast every floating leaf of a nested dict/list to ``dtype``.  A leaf
    already in ``dtype`` is returned as is (no copy)."""
    if isinstance(tree, dict):
        return {k: cast_tree(v, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(cast_tree(v, dtype) for v in tree)
    if isinstance(tree, torch.Tensor) and tree.is_floating_point():
        return tree.to(dtype)
    return tree
