"""Shared model building blocks (port of `repro/models/common.py`): policy
resolution, the dense layer, RMSNorm, RoPE, embeddings, the cross-entropy
loss, PRNG key folding and dtype casts.

Parameters are plain nested dicts of tensors, laid out as in the reference
(a dense weight is (K, N) and ``dense`` computes ``x @ w``), so that
`repro_torch.convert.params_from_jax` is a leaf-by-leaf copy.
"""
from __future__ import annotations

import dataclasses

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
def resolve_policy(td: TDExecCfg, device=None) -> td_policy.TDPolicy:
    return resolve_policies([td], device=device)[0]


def resolve_policies(tds, scenario=None, corner=None,
                     device=None) -> list[td_policy.TDPolicy]:
    """Resolve many layer configs at once: all "td"-mode entries are solved
    by one batched (R, q, sigma) call per weight bit width.  A named
    `scenario`/`corner` (core.scenario) resolves each "td" entry's
    operating point first: corner-derated error budget, grid-argmin supply
    (`tdsim.policy.apply_scenario`).  A corner without a scenario resolves
    against the default 'vdd-opt' supply grid.  ``device``: where the
    solve sweeps (None = the explorer service's device, CUDA)."""
    if corner is not None and scenario is None:
        scenario = "vdd-opt"
    out: list[td_policy.TDPolicy | None] = [None] * len(tds)
    td_specs, td_idx = [], []
    for i, td in enumerate(tds):
        if td.mode == "precise":
            out[i] = td_policy.PRECISE
        elif td.mode == "quant":
            out[i] = td_policy.quant_policy(td.bits_a, td.bits_w)
        elif td.mode == "td":
            td_specs.append(td_policy.TDLayerSpec(
                td.bits_a, td.bits_w, td.n_chain, td.sigma_max))
            td_idx.append(i)
        else:
            raise ValueError(f"unknown td mode {td.mode!r}")
    if scenario is not None and td_specs:
        td_specs = td_policy.apply_scenario(td_specs, scenario, corner,
                                            device=device)
    for i, pol in zip(td_idx, td_policy.solve_td_policies(td_specs, device)):
        out[i] = pol
    return out  # type: ignore[return-value]


def resolve_arch_policy(arch: ArchConfig, device=None
                        ) -> td_policy.TDPolicy | td_policy.NetworkPolicy:
    """Resolve an ArchConfig's execution policy in one shot.

    Homogeneous (`td_per_layer is None`) -> a single TDPolicy.
    Heterogeneous -> every per-layer TDExecCfg plus the top-level `td` go
    through one `resolve_policies` call and come back as a NetworkPolicy
    (decoder family only).  `arch.scenario`/`arch.corner` resolve every
    "td"-mode matmul's operating point for that named scenario/corner.

    `arch.td_attn` (a non-precise TDExecCfg) also resolves one policy per
    query head for TD attention, its chain length clamped to the head dim
    (the QK contraction), through the same batched solve and
    scenario/corner, attached as `NetworkPolicy.attn` (a homogeneous
    policy is promoted to a NetworkPolicy).  Decoder family only.
    """
    sc, co = arch.scenario, arch.corner
    if arch.td_per_layer is None:
        base = resolve_policies([arch.td], scenario=sc, corner=co,
                                device=device)[0]
    else:
        if arch.model.family != "decoder":
            raise ValueError("per-layer TD policies require a decoder-family "
                             f"model, got {arch.model.family!r}")
        n_layers = arch.model.n_layers
        if len(arch.td_per_layer) != n_layers:
            raise ValueError(
                f"td_per_layer has {len(arch.td_per_layer)} entries for "
                f"{n_layers}-layer model {arch.model.name!r}")
        pols = resolve_policies(list(arch.td_per_layer) + [arch.td],
                                scenario=sc, corner=co, device=device)
        base = td_policy.NetworkPolicy(layers=tuple(pols[:-1]), top=pols[-1])

    td_attn = arch.td_attn
    if td_attn is not None and td_attn.mode != "precise":
        if arch.model.family != "decoder":
            raise ValueError("td_attn requires a decoder-family model, "
                             f"got {arch.model.family!r}")
        spec = dataclasses.replace(
            td_attn, n_chain=min(td_attn.n_chain, arch.model.hd))
        attn_pols = tuple(resolve_policies([spec] * arch.model.n_heads,
                                           scenario=sc, corner=co,
                                           device=device))
        if isinstance(base, td_policy.NetworkPolicy):
            base = dataclasses.replace(base, attn=attn_pols)
        else:
            base = td_policy.NetworkPolicy(
                layers=(base,) * arch.model.n_layers, top=base,
                attn=attn_pols)
    return base


# ---------------------------------------------------------------------------
# Runtime operating points (drift adaptation; `repro/models/common.py:116-178`)
# ---------------------------------------------------------------------------
def runtime_td_policy(pol, ops: torch.Tensor):
    """Rebind every "td"-mode layer policy's (sigma_chain, tdc_q) to the
    runtime operand tensor ``ops``: the hot-swap hook of the drift-adaptive
    decode step.

    ``ops`` is ``(2,)`` f32 ``[sigma, q]`` applied to every TD layer, or
    ``(L, 2)`` for per-layer operating points.  Each bound policy holds
    0-d views of its row, and `kernels.td_vmm.ops` hands that row to the
    kernel as its ``params`` operand: writing new values into ``ops`` (in
    place) moves the operating point of the same step, with no copy and no
    host read.  Non-"td" policies pass through; a NetworkPolicy's `top`
    and `attn` are left as solved."""
    def bind(p: td_policy.TDPolicy, row) -> td_policy.TDPolicy:
        if p.mode != "td":
            return p
        return p.replace(sigma_chain=row[0], tdc_q=row[1])

    if isinstance(pol, td_policy.NetworkPolicy):
        rows = [ops[i] if ops.ndim == 2 else ops for i in range(len(pol))]
        return dataclasses.replace(
            pol, layers=tuple(bind(p, r) for p, r in zip(pol.layers, rows)))
    return bind(pol, ops[0] if ops.ndim == 2 else ops)


def td_policy_ops(pol, device=None) -> torch.Tensor:
    """The ``(L, 2)`` (or ``(2,)`` for a plain policy) float32 operand
    tensor of a solved policy, the value `runtime_td_policy` rebinds, on
    ``device`` (None: the host)."""
    if isinstance(pol, td_policy.NetworkPolicy):
        vals = [[float(p.sigma_chain), float(p.tdc_q)] for p in pol.layers]
    else:
        vals = [float(pol.sigma_chain), float(pol.tdc_q)]
    return torch.tensor(vals, dtype=torch.float32, device=device)


def td_layer_indices(pol) -> list[int]:
    """Indices of the "td"-mode layer policies of ``pol`` (the layers the
    drift loop re-resolves; a plain TDPolicy is layer 0 or nothing)."""
    if isinstance(pol, td_policy.NetworkPolicy):
        return [i for i, p in enumerate(pol.layers) if p.mode == "td"]
    return [0] if pol.mode == "td" else []


def replace_td_layers(pol, solved):
    """``pol`` with its "td"-mode layers replaced by ``solved`` (one new
    TDPolicy per `td_layer_indices` entry, in order); `top`, `attn` and the
    other layers pass through.  Both the (sigma, q) hot swap and the
    staged supply swap rebuild the policy set with it."""
    idx = td_layer_indices(pol)
    solved = list(solved)
    if len(solved) != len(idx):
        raise ValueError(f"need {len(idx)} solved td layers, "
                         f"got {len(solved)}")
    if not idx:
        return pol
    if isinstance(pol, td_policy.NetworkPolicy):
        layers = list(pol.layers)
        for i, p in zip(idx, solved):
            layers[i] = p
        return dataclasses.replace(pol, layers=tuple(layers))
    return solved[0]


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
