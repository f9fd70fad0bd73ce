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
from torch.distributed.tensor import DTensor, Partial, Replicate

from repro_torch import prng
from repro_torch.configs.base import ArchConfig, TDExecCfg
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import sharding
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
# Sharding constraints (identity outside an active mesh)
# ---------------------------------------------------------------------------
def _abstract_mesh():
    """The ambient mesh (`launch.mesh.activate_mesh`), or None."""
    return mesh_lib.active_mesh()


def maybe_constrain(x: torch.Tensor, *axes) -> torch.Tensor:
    """Redistribute the DTensor ``x`` to the spec ``axes`` (one entry a
    dim: None, an axis name or a tuple of them) if a mesh providing every
    named axis is active; otherwise, and on a plain tensor, the identity.
    Axes that do not divide their dim are dropped, as the reference's
    `with_sharding_constraint` wrapper drops them.  Lets model code carry
    distribution hints without coupling tests to a mesh."""
    env = _abstract_mesh()
    if env is None:
        return x
    if not isinstance(x, DTensor):
        return x
    names = set(mesh_lib.axis_names(env))

    def ok(a):
        if a is None:
            return True
        if isinstance(a, (tuple, list)):
            return all(n in names for n in a)
        return a in names

    if not all(ok(a) for a in axes):
        return x
    fixed = []
    for dim, a in zip(x.shape, axes):
        if a is None:
            fixed.append(None)
            continue
        ax = (a,) if isinstance(a, str) else tuple(a)
        n = 1
        for nm in ax:
            n *= mesh_lib.axis_size(env, nm)
        fixed.append(a if dim % n == 0 else None)
    pl = sharding.placements(tuple(fixed), x.device_mesh)
    if tuple(pl) == tuple(x.placements):
        return x
    return x.redistribute(x.device_mesh, pl)


def state_device(device):
    """Where a fresh decode state is built: ``meta`` (shapes only) on an
    active mesh, whose `place_state` then makes each rank's own shards;
    else ``device`` resolved."""
    from repro_torch import device as device_mod
    if _abstract_mesh() is not None:
        return torch.device("meta")
    return device_mod.resolve(device)


def place_state(state):
    """A fresh (all-zero) decode state (KV caches, SSM states) as DTensors
    on the ambient mesh, placed by `launch.sharding.cache_specs`, each
    rank allocating only its shards; as it is without a mesh."""
    env = _abstract_mesh()
    if env is None:
        return state
    from torch.distributed.tensor import zeros as dzeros
    specs = sharding.cache_specs(state, env)
    flat = {}
    sharding.map_with_path(lambda p, sp: flat.__setitem__(p, sp), specs)
    return sharding.map_with_path(
        lambda p, t: dzeros(tuple(t.shape), dtype=t.dtype, device_mesh=env,
                            placements=sharding.placements(flat[p], env))
        if isinstance(t, torch.Tensor) else t, state)


def write_seq(buf: torch.Tensor, start: int, val: torch.Tensor) -> None:
    """``buf[:, start:start + S] = val`` (S = val's dim 1).  On a DTensor
    ``buf`` split over dim 1 (a KV cache split over its sequence), each
    rank writes the part of ``val`` that falls in its own block, so no
    rank gathers the cache."""
    s = val.shape[1]
    if not (isinstance(buf, DTensor)
            and any(p.is_shard(1) for p in buf.placements)):
        buf[:, start:start + s] = val
        return
    mesh = buf.device_mesh
    pl = [Replicate() if p.is_shard(1) else p for p in buf.placements]
    if not isinstance(val, DTensor):
        val = DTensor.from_local(val, mesh, [Replicate()] * mesh.ndim,
                                 run_check=False)
    v_loc = val.redistribute(mesh, pl).to_local().detach()
    b_loc = buf._local_tensor
    names = mesh_lib.axis_names(mesh)
    lo, _ = sharding.local_block(buf.shape[1], mesh, tuple(
        a for a, p in zip(names, buf.placements) if p.is_shard(1)))
    n = b_loc.shape[1]
    a, z = max(start, lo), min(start + s, lo + n)
    if a < z:
        b_loc[:, a - lo:z - lo] = v_loc[:, a - start:z - start]


def argmax_last(x: torch.Tensor) -> torch.Tensor:
    """``argmax(x, -1)``; a DTensor split over its last dim (the logits'
    vocabulary) is gathered over it first."""
    last = x.dim() - 1
    if isinstance(x, DTensor) and any(p.is_shard(last)
                                      for p in x.placements):
        x = x.redistribute(x.device_mesh, [
            Replicate() if p.is_shard(last) else p for p in x.placements])
    return torch.argmax(x, dim=-1)


def batch_sharding_axes(env=None):
    """The axes that shard the batch on the ambient mesh, or None."""
    env = env or _abstract_mesh()
    if env is None:
        return None
    return ("pod", "data") if "pod" in mesh_lib.axis_names(env) else "data"


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
    table = params["table"]
    if isinstance(table, DTensor):
        # the table's rows gathered over the vocabulary's axes (DTensor's
        # vocab-parallel lookup leaves a masked partial sum that its
        # backward cannot turn back), then the rows looked up and split
        # over the batch
        table = table.redistribute(table.device_mesh, [
            Replicate() if p.is_shard(0) else p for p in table.placements])
        out = torch.nn.functional.embedding(ids, table)
        if any(p.is_partial() for p in out.placements):
            # DTensor may still split a replicated table over its
            # vocabulary when that moves the fewest bytes (a small table
            # against a long batch of ids): the lookup is then a masked
            # partial sum, which is reduced here.  Its gradient comes back
            # as a plain partial sum, which DTensor cannot turn into the
            # masked one that the lookup's backward reads: it is reduced
            # too, and the lookup's backward takes it replicated.
            out = out.redistribute(out.device_mesh, _unpartial(out))
            if out.requires_grad:
                out.register_hook(
                    lambda g: g.redistribute(g.device_mesh, _unpartial(g)))
        return maybe_constrain(out, batch_sharding_axes(),
                               *([None] * (out.dim() - 1)))
    return table[ids]


def _unpartial(x: DTensor) -> list:
    """``x``'s placements with every partial sum replaced by Replicate."""
    return [Replicate() if p.is_partial() else p for p in x.placements]


def _pick(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """``logits[..., labels]``.  On a DTensor split over its vocabulary each
    rank picks the labels in its own block (zero elsewhere) and the
    result is a partial sum over the vocabulary's mesh axes, as a
    vocab-parallel cross-entropy does: the logits are never gathered."""
    last = logits.dim() - 1
    if not (isinstance(logits, DTensor)
            and any(p.is_shard(last) for p in logits.placements)):
        return torch.gather(logits, -1,
                            labels[..., None].to(torch.int64))[..., 0]
    mesh = logits.device_mesh
    names = mesh_lib.axis_names(mesh)
    vocab = tuple(a for a, p in zip(names, logits.placements)
                  if p.is_shard(last))
    lab_pl = [Replicate() if p.is_shard(last) else p
              for p in logits.placements]
    if not isinstance(labels, DTensor):
        labels = DTensor.from_local(labels, mesh, [Replicate()] * mesh.ndim,
                                    run_check=False)
    lab = labels.redistribute(mesh, lab_pl).to_local().to(torch.int64)
    lg = logits.to_local()
    n = lg.shape[-1]
    lo, _ = sharding.local_block(logits.shape[-1], mesh, vocab)
    inside = (lab >= lo) & (lab < lo + n)
    picked = torch.gather(lg, -1, (lab - lo).clamp(0, n - 1)[..., None])
    picked = torch.where(inside, picked[..., 0], 0.0)
    out_pl = [Partial() if p.is_shard(last) else p
              for p in logits.placements]
    return DTensor.from_local(picked, mesh, out_pl, run_check=False)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: torch.Tensor | None = None,
                  z_coef: float = 1e-4) -> torch.Tensor:
    """Mean next-token CE with z-loss; logits (..., V), labels (...)."""
    logits = logits.to(torch.float32)
    lse = torch.logsumexp(logits, dim=-1)
    ll = _pick(logits, labels)
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
